"""The port's CLI with the flags this slice ports, on the CPU (--device cpu)
and a tiny plane (tests/test_deepwave.py's Options; 4 cameras x 128 px, 30
points, MAX_TREE_LEVEL 5). One run takes --checkpoint_every, --ba (bundle
adjustment before seeding), --ba_dense_every (inside the loop) and
--profile (a torch.profiler Chrome trace, the port's spans in it); a
second --resume's from its checkpoint with --ba_dense (after the loop).
Each writes patches-final.ply with >= 0.95 of its patches within 0.02 of
the plane, the second within 10% of the first's count. --platform is refused, naming --device;
--spatial and --image_subsets behave as the JAX CLI's on one device:
--spatial fails for want of a device mesh, --image_subsets alone is
ignored (it needs --spatial) and the run completes."""

import json
import os

import numpy as np
import pytest
import torch

from hpmvs_tpu_torch import cli
from hpmvs_tpu_torch.io import nvm as pnvm
from hpmvs_tpu_torch.io.ply import read_ext_ply
from hpmvs_tpu_torch.testing import make_plane_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2,
                          out_dir=str(d / "img"))
    nvm = d / "scene.nvm"
    pnvm.save_nvm(str(nvm), [ps.model])
    return ps, str(nvm)


def _run(plane, outdir, *flags):
    _, nvm = plane
    rc = cli.main(["--nvm", nvm, "--outdir", str(outdir), "--start_level",
                   "1", "--max_views", "6", "--covis_min_points", "10",
                   "--maxtreelevel", "5", "--device", "cpu", *flags])
    assert rc == 0
    got = read_ext_ply(str(outdir / "patches-final.ply"))
    assert len(got["xyz"]) > 50
    assert (np.abs(got["xyz"][:, 2] - plane[0].plane_z) < 0.02).mean() >= 0.95
    return got


@pytest.fixture(scope="module")
def first_run(plane, tmp_path_factory):
    """--checkpoint_every, --ba, --ba_dense_every and --profile in one run
    (one CPU run of the plane takes ~40 s)."""
    out = tmp_path_factory.mktemp("first")
    got = _run(plane, out / "o", "--checkpoint_every", "10", "--ba",
               "--ba_dense_every", "1", "--profile", str(out / "prof"))
    return out, got


def test_checkpoint_every_writes_a_checkpoint(first_run):
    out, _ = first_run
    assert (out / "o" / "checkpoint.npz").exists()


def test_resume_with_ba_dense(plane, first_run, tmp_path):
    """--resume from the last checkpoint the first run wrote (the queue
    rebuilt from its tree), then --ba_dense over the final cloud."""
    out, a = first_run
    b = _run(plane, tmp_path / "b", "--resume",
             str(out / "o" / "checkpoint.npz"), "--ba_dense")
    assert abs(len(b["xyz"]) - len(a["xyz"])) <= 0.1 * len(a["xyz"])


def test_profile_writes_a_chrome_trace(first_run):
    out, _ = first_run
    with open(out / "prof" / "trace.json") as fh:
        trace = json.load(fh)
    assert len(trace["traceEvents"]) > 100


def test_profile_trace_shows_the_spans(first_run):
    """--profile turns the span recorder on with record_function ranges,
    so the Chrome trace names the port's layers above the kernels."""
    out, _ = first_run
    with open(out / "prof" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"job", "load", "load.nvm", "load.images", "load.seed", "step",
            "cells.extend", "dispatch", "opt.refine", "depth.gates", "wait",
            "io.save_ply", "hook"} <= names


@pytest.mark.parametrize("flag,outcome,message", [
    (["--platform", "cpu"], "exit", "--device"),
    (["--spatial"], "raise", "spatial=True requires a device mesh"),
    (["--image_subsets"], "run", None)])
def test_refused_flags(plane, tmp_path, capsys, flag, outcome, message):
    """On one device (no mesh): --platform exits naming --device;
    --spatial raises the JAX CLI's ValueError before any output;
    --image_subsets without --spatial is ignored, as in the JAX pipeline,
    and a short run (MAX_TREE_LEVEL 4) writes its cloud."""
    ps, nvm = plane
    argv = ["--nvm", nvm, "--outdir", str(tmp_path), "--device", "cpu",
            "--start_level", "1", "--max_views", "6", "--covis_min_points",
            "10", "--maxtreelevel", "4", *flag]
    if outcome == "exit":
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert flag[0] in err and message in err
        assert not os.path.exists(tmp_path / "patches-final.ply")
    elif outcome == "raise":
        with pytest.raises(ValueError, match=message):
            cli.main(argv)
        assert not os.path.exists(tmp_path / "patches-final.ply")
    else:
        assert cli.main(argv) == 0
        got = read_ext_ply(str(tmp_path / "patches-final.ply"))
        assert len(got["xyz"]) > 0
        assert (np.abs(got["xyz"][:, 2] - ps.plane_z) < 0.02).mean() >= 0.95
