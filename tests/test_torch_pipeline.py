"""The port's progressive reconstruction end to end vs the JAX engine, on the
small plane of tests/test_deepwave.py with the same Options (WAVE_DEPTH=1,
WAVE_LOOKAHEAD=False).

On the CPU the JAX engine refines with its XLA _optimize_patch (8 full
iterations, no early stop) and the port with its GN twin (block early stop,
final value-only trial), so parity is statistical: alive patches within
10%, at least 95% of each cloud within 0.02 of plane_z, and the same modal
octree level. The port's CLI must write patches-final.ply."""

import numpy as np
import pytest
import torch

from hpmvs_tpu.config import Options as JOptions
from hpmvs_tpu.runtime import pipeline as jpipe
from hpmvs_tpu.testing import make_plane_scene

from hpmvs_tpu_torch import cli
from hpmvs_tpu_torch.config import Options as POptions
from hpmvs_tpu_torch.io import nvm as pnvm
from hpmvs_tpu_torch.io.ply import read_ext_ply
from hpmvs_tpu_torch.runtime import pipeline as ppipe

from torch_parity import plane_options

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    out = tmp_path_factory.mktemp("runs")
    jo = plane_options(JOptions, WAVE_DEPTH=1, WAVE_LOOKAHEAD=False,
                       OUTFOLDER=str(out / "jax"))
    po = plane_options(POptions, OUTFOLDER=str(out / "port"))
    je = jpipe.run(ps.model, jo, images=ps.images, mesh=None)
    pe = ppipe.run(ps.model, po, images=ps.images, device="cpu")
    return ps, je, pe, out


def test_alive_count_within_10_percent(runs):
    ps, je, pe, _ = runs
    nj, np_ = je.n_alive(), pe.n_alive()
    assert nj > 100
    assert abs(np_ - nj) <= 0.10 * nj, (nj, np_)


def test_both_clouds_on_the_plane(runs):
    ps, je, pe, _ = runs
    for e in (je, pe):
        d = np.abs(e.alive_arrays()[0][:, 2] - ps.plane_z)
        assert (d < 0.02).mean() >= 0.95


def test_same_modal_octree_level(runs):
    ps, je, pe, out = runs
    assert int(np.argmax(je.tree.histogram())) == \
        int(np.argmax(pe.tree.histogram()))
    got = read_ext_ply(str(out / "port" / "patches-final.ply"))
    assert len(got["xyz"]) == pe.n_alive()


def test_cli_writes_final_ply(tmp_path):
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2,
                          out_dir=str(tmp_path / "img"))
    nvm = tmp_path / "scene.nvm"
    pnvm.save_nvm(str(nvm), [ps.model])
    outdir = tmp_path / "out"
    rc = cli.main(["--nvm", str(nvm), "--outdir", str(outdir),
                   "--start_level", "1", "--max_views", "6",
                   "--covis_min_points", "10", "--maxtreelevel", "6",
                   "--device", "cpu"])
    assert rc == 0
    got = read_ext_ply(str(outdir / "patches-final.ply"))
    assert len(got["xyz"]) > 50
    assert (np.abs(got["xyz"][:, 2] - ps.plane_z) < 0.02).mean() >= 0.95


def test_cli_refuses_unported_flags(tmp_path):
    nvm = tmp_path / "x.nvm"
    nvm.write_text("NVM_V3\n0")
    for flag in (["--ba"], ["--resume", "ck.npz"], ["--spatial"]):
        with pytest.raises(SystemExit):
            cli.main(["--nvm", str(nvm), "--device", "cpu"] + flag)
