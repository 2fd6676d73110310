"""The port's progressive reconstruction end to end vs the JAX engine, on the
small plane of tests/test_deepwave.py: both engines at their defaults (wave
lookahead and WAVE_DEPTH=4, equal in both packages), and both on the classic
engine (WAVE_DEPTH=1, WAVE_LOOKAHEAD=False).

On the CPU the JAX engine refines with its XLA _optimize_patch (8 full
iterations, no early stop) and the port with its GN twin (block early stop,
final value-only trial), so parity is statistical: alive patches within
10%, at least 95% of each cloud within 0.02 of plane_z, and the same modal
octree level; at the defaults the deep chain consumes about as many
generations. The port's CLI must write patches-final.ply."""

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

CLASSIC = dict(WAVE_DEPTH=1, WAVE_LOOKAHEAD=False)


def _both(tmp_path_factory, name, **kw):
    ps = make_plane_scene(n_cams=4, imgsize=128, n_points=30, seed=2)
    out = tmp_path_factory.mktemp(name)
    jo = plane_options(JOptions, OUTFOLDER=str(out / "jax"), **kw)
    po = plane_options(POptions, OUTFOLDER=str(out / "port"), **kw)
    je = jpipe.run(ps.model, jo, images=ps.images, mesh=None)
    pe = ppipe.run(ps.model, po, images=ps.images, device="cpu")
    return ps, je, pe, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines at their own defaults."""
    return _both(tmp_path_factory, "runs")


@pytest.fixture(scope="module")
def classic_runs(tmp_path_factory):
    """Both engines on the classic engine, set explicitly."""
    return _both(tmp_path_factory, "classic", **CLASSIC)


def _alive_close(je, pe):
    nj, np_ = je.n_alive(), pe.n_alive()
    assert nj > 100
    assert abs(np_ - nj) <= 0.10 * nj, (nj, np_)


def _on_plane(ps, *engines):
    for e in engines:
        d = np.abs(e.alive_arrays()[0][:, 2] - ps.plane_z)
        assert (d < 0.02).mean() >= 0.95


def _same_modal_level(je, pe):
    assert int(np.argmax(je.tree.histogram())) == \
        int(np.argmax(pe.tree.histogram()))


def test_defaults_are_equal(runs):
    _, je, pe, _ = runs
    for f in ("WAVE_DEPTH", "WAVE_LOOKAHEAD"):
        assert getattr(je.opt, f) == getattr(pe.opt, f), f
    assert (pe.opt.WAVE_DEPTH, pe.opt.WAVE_LOOKAHEAD) == (4, True)


def test_alive_count_within_10_percent(runs):
    _, je, pe, _ = runs
    _alive_close(je, pe)


def test_both_clouds_on_the_plane(runs):
    ps, je, pe, _ = runs
    _on_plane(ps, je, pe)


def test_same_modal_octree_level(runs):
    _, je, pe, out = runs
    _same_modal_level(je, pe)
    got = read_ext_ply(str(out / "port" / "patches-final.ply"))
    assert len(got["xyz"]) == pe.n_alive()


def test_deep_against_jax_defaults(runs):
    """Both engines' deep chains engage on this scene and consume about as
    many generations; the port overflows to fallbacks no more often."""
    _, je, pe, _ = runs
    js, ps_ = je.stats, pe.stats
    assert js["disp_deep"] > 0 and ps_["disp_deep"] > 0
    jg, pg = int(js["deep_gens_consumed"]), int(ps_["deep_gens_consumed"])
    assert jg > 0 and 0.5 * jg <= pg <= 1.5 * jg, (jg, pg)
    assert ps_["deep_fb_overflow"] <= js["deep_fb_overflow"] + 2, \
        (js["deep_fb_overflow"], ps_["deep_fb_overflow"])
    assert js["lookahead_hits"] > 0 and ps_["lookahead_hits"] > 0


def test_classic_parity(classic_runs):
    """Both engines classic: alive within 10%, both on the plane, the same
    modal level; neither engine went deep or speculated."""
    ps, je, pe, _ = classic_runs
    assert (pe.opt.WAVE_DEPTH, pe.opt.WAVE_LOOKAHEAD) == (1, False)
    _alive_close(je, pe)
    _on_plane(ps, je, pe)
    _same_modal_level(je, pe)
    for e in (je, pe):
        assert e.stats.get("disp_deep", 0) == 0
        assert e.stats.get("lookahead_hits", 0) == 0


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
    """--platform is refused (argparse exit); --spatial and --image_subsets
    are ported: the parser takes them, and the run over an NVM without a
    model then fails as the JAX CLI's does (ValueError)."""
    nvm = tmp_path / "x.nvm"
    nvm.write_text("NVM_V3\n0")
    with pytest.raises(SystemExit):
        cli.main(["--nvm", str(nvm), "--device", "cpu", "--platform", "cpu"])
    for flag in (["--spatial"], ["--image_subsets"]):
        with pytest.raises(ValueError, match="no models"):
            cli.main(["--nvm", str(nvm), "--device", "cpu"] + flag)
