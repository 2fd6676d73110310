"""The port's process bring-up and host collectives (parallel/mesh.py):
init_distributed's rules, allgather's order and padding, and the
collectives' cross-process reduction.

- No launch signal (no arguments, no torchrun variables): a no-op.
- Partial arguments, a partial launch, or an initialisation that fails
  (a peer that never comes, under a 3 s timeout): it raises, never
  carries on single-process.
- A one-process group: allgather and allgather_object add the process
  axis; pmin / psum through the cross-process path (the group's
  allgather, staged through the host) equal the single-process ones.
- Two processes (gloo on 127.0.0.1): ragged allgather rows padded with
  zeros, in process order; make_mesh puts process 0's shards first;
  psum / pmin across the processes equal to one process's sum and min
  over all 8 shards, the same bits on both; a collective that one process
  skips fails within the group timeout instead of hanging.
- A torchrun-style launch of pipeline.run (the launcher's variables,
  WORLD_SIZE=2): the owned engine for spatial=True, the replicated Engine
  otherwise, one count on both processes, the PLY files written."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hpmvs_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def no_launch(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_launch_signal_is_noop(no_launch):
    assert pmesh.init_distributed() == 1
    assert not dist.is_initialized()
    assert pmesh.process_index() == 0 and pmesh.process_count() == 1
    np.testing.assert_array_equal(pmesh.allgather(np.arange(3)),
                                  [[0, 1, 2]])


def test_partial_launch_raises(no_launch, monkeypatch):
    with pytest.raises(ValueError):
        pmesh.init_distributed("tcp://127.0.0.1:1", world_size=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        pmesh.init_distributed()
    assert not dist.is_initialized()


def test_failed_init_raises(no_launch):
    # rank 1 of 2 waits for a store that nobody serves: the bring-up fails
    # at the timeout and raises
    with pytest.raises(Exception):
        pmesh.init_distributed(f"127.0.0.1:{_free_port()}", world_size=2,
                               rank=1, timeout_s=3.0)
    assert not dist.is_initialized()


def test_one_process_group(no_launch):
    port = _free_port()
    assert pmesh.init_distributed(f"tcp://127.0.0.1:{port}", 1, 0) == 1
    assert dist.is_initialized()
    # an initialised group is kept
    assert pmesh.init_distributed(f"tcp://127.0.0.1:{port}", 1, 0) == 1
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(pmesh.allgather(x), x[None])
    assert pmesh.allgather(np.int64(7)).tolist() == [7]
    assert pmesh.allgather_object({"a": 1}) == [{"a": 1}]
    mesh = pmesh.make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.n_proc == 1 and mesh.local.all()
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.normal(size=5).astype(np.float32))
             for _ in range(4)]
    single = pmesh.psum(parts)
    reps = [p.clone() for p in parts]
    pmesh.pmin(reps)
    # the cross-process path: the same mesh read as spanning processes
    mesh.n_proc = 2
    across = pmesh.psum(parts, mesh)
    reps_x = [p.clone() for p in parts]
    pmesh.pmin(reps_x, mesh)
    for a, b in zip(single, across):
        assert torch.equal(a, b)
    for a, b in zip(reps, reps_x):
        assert torch.equal(a, b)
    assert torch.equal(reps_x[0], torch.stack(parts).min(0).values)


TWO_PROCESSES = r"""
import sys
import time
import numpy as np
import torch
torch.set_num_threads(1)
from hpmvs_tpu_torch.parallel import mesh as pmesh
pid, port = int(sys.argv[1]), int(sys.argv[2])
assert pmesh.init_distributed(f"127.0.0.1:{port}", 2, pid,
                              timeout_s=5.0) == 2
# ragged rows: process p sends p + 1 rows of (p + 1) * 10 + row
x = (np.arange(pid + 1) + (pid + 1) * 10).astype(np.int32)[:, None]
g = pmesh.allgather(np.repeat(x, 2, axis=1))
assert g.shape == (2, 2, 2), g.shape
assert g[:, :, 0].tolist() == [[10, 0], [20, 21]], g
assert pmesh.allgather_object(("p", pid)) == [("p", 0), ("p", 1)]
mesh = pmesh.make_mesh(["cpu"] * 4)
assert mesh.shard_proc.tolist() == [0] * 4 + [1] * 4
assert mesh.local_ids.tolist() == list(range(4 * pid, 4 * pid + 4))
rng = np.random.default_rng(3)
allp = [torch.as_tensor(rng.normal(size=6).astype(np.float32))
        for _ in range(8)]
mine = [p if mesh.local[i] else None for i, p in enumerate(allp)]
tot = next(t for t in pmesh.psum(mine, mesh) if t is not None)
local_sum = sum(allp[4 * pid + 1:4 * pid + 4], allp[4 * pid])
exp = [sum(allp[1:4], allp[0]), sum(allp[5:8], allp[4])]
assert torch.equal(tot, exp[0] + exp[1])
assert torch.equal(local_sum, exp[pid])
reps = [None if p is None else p.clone() for p in mine]
pmesh.pmin(reps, mesh)
m = next(r for r in reps if r is not None)
assert torch.equal(m, torch.stack(allp).min(0).values)
both = pmesh.allgather(tot.numpy())
assert np.array_equal(both[0], both[1])
print("SAME_BITS", flush=True)
# process 1 skips the next collective: process 0's fails at the timeout
if pid == 0:
    t = time.time()
    try:
        pmesh.allgather(np.int64(1))
    except Exception:
        print("SKIPPED_COLLECTIVE_RAISED %.1f" % (time.time() - t),
              flush=True)
else:
    time.sleep(12.0)
"""


def test_two_processes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for k in LAUNCH_VARS:
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", TWO_PROCESSES,
                               str(pid), str(port)], cwd=root, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert "SAME_BITS" in out, out[-4000:]
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("SKIPPED_COLLECTIVE_RAISED")]
    assert line, outs[0][-4000:]
    assert float(line[0].split()[1]) < 11.0


LAUNCH = r"""
import dataclasses
import json
import os
import sys
import torch
torch.set_num_threads(1)
from hpmvs_tpu_torch.config import Options
from hpmvs_tpu_torch.runtime import pipeline
from hpmvs_tpu_torch.testing import make_plane_scene
out_dir = sys.argv[1]
ps = make_plane_scene(n_cams=4, imgsize=96, n_points=24, seed=0)
res = {}
for spatial in (True, False):
    opt = dataclasses.replace(
        Options(), START_LEVEL=1, MAXLEVEL=3, MAX_VIEWS=6,
        COVIS_MIN_POINTS=10, LM_ITERS=4,
        OUTFOLDER=os.path.join(out_dir, f"spatial{int(spatial)}"))
    eng = pipeline.run(ps.model, opt, images=ps.images, device="cpu",
                       spatial=spatial, max_prio=45)
    res[str(spatial)] = dict(cls=type(eng).__name__, alive=eng.n_alive(),
                             shards=eng.mesh.size, procs=eng.mesh.n_proc)
print("LAUNCH " + json.dumps(res), flush=True)
"""


def test_torchrun_style_launch(tmp_path):
    """pipeline.run under torchrun's variables (WORLD_SIZE=2): the process
    group comes up from them, the mesh spans both processes' CPU shards,
    spatial=True runs the owned engine and spatial=False the replicated
    one; both processes see one count; process 0 writes the PLY files."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(pid), WORLD_SIZE="2",
                   LOCAL_RANK=str(pid), LOCAL_WORLD_SIZE="2")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LAUNCH, str(tmp_path)], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    res = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("LAUNCH ")]
        assert line, out[-4000:]
        res.append(json.loads(line[-1].split(" ", 1)[1]))
    assert res[0] == res[1]
    r = res[0]
    assert r["True"]["cls"] == "OwnedSpatialEngine"
    assert r["False"]["cls"] == "Engine"
    for v in r.values():
        assert v["shards"] == 2 and v["procs"] == 2 and v["alive"] > 24
    for sub in ("spatial1", "spatial0"):
        assert (tmp_path / sub / "patches-final.ply").exists()
