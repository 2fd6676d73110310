"""The port's entry points run on the GPU unless the caller asks for the
CPU: with no CUDA device visible (torch.cuda.is_available patched to False,
so the test means the same on a machine with a card), every entry point
raises a RuntimeError that names device="cpu" when given no device, and runs
when given device="cpu" (--device cpu for the CLI)."""

import numpy as np
import pytest
import torch

from hpmvs_tpu_torch import cli, interop, resolve_device
from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.core import depth as pdepth
from hpmvs_tpu_torch.core import scene as pscene
from hpmvs_tpu_torch.geom import camera as pcam
from hpmvs_tpu_torch.io import nvm as pnvm
from hpmvs_tpu_torch.runtime import pipeline
from hpmvs_tpu_torch.runtime.wavefront import Engine
from hpmvs_tpu_torch.testing import make_plane_scene

from torch_parity import plane_options

torch.set_num_threads(1)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    d = tmp_path_factory.mktemp("plane")
    ps = make_plane_scene(n_cams=4, imgsize=64, n_points=10, seed=2,
                          out_dir=str(d / "img"))
    nvm = d / "scene.nvm"
    pnvm.save_nvm(str(nvm), [ps.model])
    return ps, str(nvm)


def _opt(tmp_path):
    return plane_options(POptions, MAX_TREE_LEVEL=4,
                         OUTFOLDER=str(tmp_path / "out"))


def test_resolve_device(no_gpu):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match="GPU"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["engine", "pipeline", "scene", "depth",
                                   "interop", "cameras"])
def test_entry_points_refuse_the_cpu_by_default(no_gpu, plane, tmp_path,
                                                entry):
    ps, _ = plane
    opt = _opt(tmp_path)
    w, h = np.full((4, 4), 64, np.int32), np.full((4, 4), 64, np.int32)
    calls = {
        "engine": lambda **kw: Engine(ps.model, opt, images=ps.images, **kw),
        "pipeline": lambda **kw: pipeline.run(ps.model, opt,
                                              images=ps.images, **kw),
        "scene": lambda **kw: pscene.build_scene(ps.model, opt,
                                                 images=ps.images, **kw),
        "depth": lambda **kw: pdepth.build_depth_pack(w, h, **kw),
        "interop": lambda **kw: interop.depth_pack_from_numpy(
            np.zeros(4, np.float32), np.zeros((1, 1), np.int32),
            np.ones((1, 1), np.int32), np.full((1, 1), 4, np.int32), **kw),
        "cameras": lambda **kw: pcam.build_cameras(ps.model.cameras,
                                                   [64] * 4, [64] * 4,
                                                   opt.MAXLEVEL, **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    if entry != "pipeline":   # the whole run: test_pipeline_runs_on_cpu
        calls[entry](device="cpu")


def test_pipeline_runs_on_cpu_when_asked(no_gpu, plane, tmp_path):
    ps, _ = plane
    eng = pipeline.run(ps.model, _opt(tmp_path), images=ps.images,
                       device="cpu")
    assert eng.device.type == "cpu" and eng.n_alive() > 0


def test_cli_needs_device_cpu(no_gpu, plane, tmp_path):
    _, nvm = plane
    args = ["--nvm", nvm, "--outdir", str(tmp_path / "out"),
            "--start_level", "1", "--max_views", "6",
            "--covis_min_points", "10", "--maxtreelevel", "4"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args)
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / "out" / "patches-final.ply").exists()
