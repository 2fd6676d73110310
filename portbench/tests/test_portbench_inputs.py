"""The benchmark's frozen generators and writers against the program's."""

import numpy as np

from portbench import scenes


def test_facade_copy_equals_program_at_256px(tmp_path):
    from hpmvs_tpu_torch import testing
    a = scenes.make_facade(n_cams=11, imgsize=256, n_points=300, seed=3)
    b = testing.make_facade_scene(n_cams=11, imgsize=256, n_points=300,
                                  seed=3)
    assert all(np.array_equal(x, y) for x, y in zip(a["images"], b.images))
    assert np.array_equal(a["points"], b.model.points_xyz)
    m = np.array([(ci, x, y) for _, ci, x, y in a["meas"]])
    assert np.array_equal(m[:, 0], b.model.meas_img)
    assert np.array_equal(m[:, 1:], b.model.meas_xy)
    for ca, cb in zip(a["cameras"], b.model.cameras):
        assert np.array_equal(ca["rq"], cb.rq)
        assert np.array_equal(ca["c"], cb.c)
        assert (ca["f"], ca["k1"]) == (cb.f, cb.r)


def test_ring_copy_equals_program_at_256px():
    from hpmvs_tpu_torch import testing
    a = scenes.make_ring_plane(n_cams=40, imgsize=256, n_points=150, seed=5)
    b = testing.make_ring_plane_scene(n_cams=40, imgsize=256, n_points=150,
                                      seed=5)
    assert all(np.array_equal(x, y) for x, y in zip(a["images"], b.images))
    assert np.array_equal(a["points"], b.model.points_xyz)
    m = np.array([(ci, x, y) for _, ci, x, y in a["meas"]])
    assert np.array_equal(m[:, 0], b.model.meas_img)
    assert np.array_equal(m[:, 1:], b.model.meas_xy)
    for ca, cb in zip(a["cameras"], b.model.cameras):
        assert np.array_equal(ca["rq"], cb.rq) and ca["f"] == cb.f


def test_written_files_read_back_through_the_program(tmp_path):
    from hpmvs_tpu_torch.image import pyramid
    from hpmvs_tpu_torch.io import nvm
    sc = scenes.make_facade(n_cams=5, imgsize=64, n_points=40, seed=9)
    path = scenes.write_scene(sc, str(tmp_path))
    model = nvm.read_nvm(path)[0]
    assert len(model.cameras) == 5
    assert np.array_equal(model.points_xyz, sc["points"])
    for cam, want, img in zip(model.cameras, sc["cameras"], sc["images"]):
        assert np.array_equal(pyramid.load_image(cam.filename), img)
        assert np.array_equal(scenes.read_hpi(cam.filename), img)
        assert np.array_equal(cam.rq, want["rq"])
        assert (cam.f, cam.r) == (want["f"], want["k1"])
    starts = np.searchsorted([m[0] for m in sc["meas"]],
                             np.arange(len(sc["points"]) + 1))
    assert np.array_equal(model.meas_start, starts)


def test_run_seed_permutes_channels_of_a_fixed_scene():
    a = scenes.make_scene("ring_plane", {"n_cams": 6, "imgsize": 32,
                                         "n_points": 20, "seed": 0}, 7)
    b = scenes.make_scene("ring_plane", {"n_cams": 6, "imgsize": 32,
                                         "n_points": 20, "seed": 0}, 7)
    plain = scenes.make_ring_plane(n_cams=6, imgsize=32, n_points=20, seed=0)
    perm = a["channels"]
    assert sorted(perm) == [0, 1, 2]
    for x, y, z in zip(a["images"], b["images"], plain["images"]):
        assert np.array_equal(x, y) and np.array_equal(x, z[..., perm])
    assert np.array_equal(a["points"], plain["points"])
    assert a["meas"] == plain["meas"]
