"""One run of one benchmark cell: set-up, the measured window, the check
that decides `correct`, and the metrics.

A cell is found by name in BENCHMARK.json. Its configuration is the JSON
file the entry names (scene generator and arguments, the program's Options,
mesh and further arguments of `run_nvm_file` such as `spatial`, the
guarantees the reference holds it to), its traffic mix is
`traffic/<traffic>.json` (jobs back to back; an optional `jobs` caps their
number in a window), each metric is
`metrics/<metric>.py` (a `read(rec)` that returns a number or None, and an
optional `install(rec)` run before a traced window), and each cell's limits
are `limits/<cell>.json` (each key a number of the reference's verdict that
must not exceed its value). Nothing here names a cell, a configuration or a
metric, so a cell is added with files alone.

The window: reconstructions back to back through the program's CLI path,
`pipeline.run_nvm_file`, from the NVM and raw images written at set-up.
Jobs start while the window (`--seconds`) is open; every job that started
runs to its end, its answer being due, and the window closes when the last
one returns (a job still running a minute past `--seconds` is stopped by
its hook and delivers its cloud as of then). Hooks read the host clock
only.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hpmvs_tpu")


class Cut(Exception):
    """Raised from a hook to stop a job (the warm-up at the end of its first
    level, or a job still running a minute past the window's close)."""


LATE_S = 60.0


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limit: dict
    metrics: list        # [(entry of BENCHMARK.json, reader module)]
    chips: int


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader module of metric `name` (portbench/metrics/<name>.py)."""
    return _load_module(HERE / "metrics" / f"{name}.py", name)


def _data(root: Path, kind: str, name: str) -> Path:
    """File `name` of `kind` (traffic, limits, metrics): in BENCHMARK.json's
    folder when that folder has the kind, else beside the harness."""
    folder = root / kind if (root / kind).is_dir() else HERE / kind
    return folder / name


def find_cell(workload: str, trace: bool, bench_path: Path) -> Cell:
    """The cell's files by name; paths in BENCHMARK.json are relative to
    its folder."""
    root = bench_path.parent
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(_data(root, "traffic", f"{w['traffic']}.json")
                         .read_text())
    limit = json.loads(_data(root, "limits", f"{workload}.json").read_text())
    metrics = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        metrics.append((m, _load_module(
            _data(root, "metrics", f"{m['name']}.py"), m["name"])))
    return Cell(workload, config, traffic, limit, metrics, int(w["chips"]))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: hpmvs_tpu_torch is not hpmvs_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _options(config: dict, outfolder: str):
    from hpmvs_tpu_torch.config import Options
    return dataclasses.replace(Options(), OUTFOLDER=outfolder,
                               **config["options"])


def _octree_of(engine) -> dict:
    """The cells of the delivered patches, for the reference to judge."""
    p, tr = engine.patches, engine.tree
    ids = np.nonzero(p.alive[:p.n])[0]
    if tr is None:
        return None
    cell = p.cell[ids].copy()
    ok = (cell >= 0) & (cell < tr.n)
    c = np.where(ok, cell, 0)
    return dict(cell=cell, cell_alive=ok & tr.alive[c],
                cell_level=tr.level[c].astype(np.int64),
                cell_key=tr.key[c].copy(),
                root_center=np.asarray(tr.center, np.float64).copy(),
                root_width=float(tr.width))


def _cloud_of(engine) -> dict:
    c, n, col, s, v, _ = engine.alive_arrays()
    return dict(center=np.asarray(c, np.float32), normal=np.asarray(n),
                color=np.clip(col, 0, 255).astype(np.uint8),
                scale=np.asarray(s), views=np.asarray(v),
                octree=_octree_of(engine))


def read_ply(path: str) -> dict:
    """The ASCII PLY the program delivers (x y z nx ny nz r g b
    scalar_scale, then one visibility list per vertex)."""
    with open(path) as fh:
        text = fh.read()
    head, body = text.split("end_header\n", 1)
    n = int(head.split("element vertex ")[1].split()[0])
    lines = body.split("\n")
    v = np.array(" ".join(lines[:n]).split(), np.float64).reshape(n, 10) \
        if n else np.zeros((0, 10))
    vis = np.array(" ".join(lines[n:2 * n]).split(), np.int64)
    k_max = 1
    views, pos = [], 0
    for _ in range(n):
        k = int(vis[pos])
        views.append(vis[pos + 1:pos + 1 + k])
        pos += 1 + k
        k_max = max(k_max, k)
    V = np.full((n, k_max), -1, np.int64)
    for i, row in enumerate(views):
        V[i, :len(row)] = row
    return dict(center=v[:, 0:3].astype(np.float32), normal=v[:, 3:6],
                color=v[:, 6:9].astype(np.uint8), scale=v[:, 9], views=V)


class Job:
    """One reconstruction's record; its hooks only read the host clock."""

    def __init__(self, deadline, stop_at_level_end: bool, trace: bool):
        self.deadline = deadline
        self.stop_first = stop_at_level_end
        self.trace = trace
        self.t_call = time.perf_counter()
        self.ns_call = time.time_ns()
        self.snaps = []        # (prio, perf_counter, time_ns, waves so far)
        self.waves = []        # perf_counter of every wave_hook
        self.first_level = None
        self.t_first_cloud = None
        self.cut = False
        self.engine = None
        self._w_level = 0

    def _late(self, engine, t):
        """Stop a job still running LATE_S past the window's close; it
        delivers its cloud as of then."""
        if t >= self.deadline:
            self.engine, self.cut = engine, True
            raise Cut()

    def wave_hook(self, engine):
        t = time.perf_counter()
        self.waves.append(t)
        self._late(engine, t)

    def snapshot_hook(self, engine, prio):
        t = time.perf_counter()
        self.snaps.append((prio, t, time.time_ns() if self.trace else 0,
                           len(self.waves)))
        # a level's last step (prio % 10 == 9) closes it; it had work if
        # a wave ran since the previous level closed
        if prio % 10 == 9:
            if self.first_level is None and len(self.waves) > self._w_level:
                self.first_level = prio // 10
                self.t_first_cloud = t
                if self.stop_first:
                    self.engine = engine
                    raise Cut()
            self._w_level = len(self.waves)
        self._late(engine, t)


def run_job(nvm, opt, device, mesh, deadline, stop_first, trace,
            run_args=None):
    from hpmvs_tpu_torch.runtime import pipeline
    job = Job(deadline, stop_first, trace)
    try:
        eng = pipeline.run_nvm_file(nvm, opt, device=device, mesh=mesh,
                                    snapshot_hook=job.snapshot_hook,
                                    wave_hook=job.wave_hook,
                                    **(run_args or {}))
        job.engine = eng
        if job.t_first_cloud is None and job.snaps:
            # the whole job was its first level
            job.first_level = job.snaps[-1][0] // 10
            job.t_first_cloud = job.snaps[-1][1]
    except Cut:
        pass
    job.t_end = time.perf_counter()
    job.ns_end = time.time_ns()
    return job


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_path: Path = None,
             t_start: float = None, plant=None) -> dict:
    """Run one cell once. Returns the result dict (the last stdout line)
    plus `checks`, the numbers compared with their limits. `plant()`
    installs the control or a fault before the window and returns what
    removes it (portbench/faults.py)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench_path = bench_path or HERE.parent / "BENCHMARK.json"
    cell = find_cell(workload, trace, bench_path)
    from portbench import scenes, reference
    cfg, trf = cell.config, cell.traffic
    work = tempfile.mkdtemp(prefix="portbench-")
    undo = None
    try:
        dev = torch.device(device)
        scene = scenes.make_scene(cfg["generator"], cfg["generator_args"],
                                  seed % (2 ** 63), device=dev)
        nvm = scenes.write_scene(scene, os.path.join(work, "scene"))
        mesh = cfg.get("mesh", "auto")
        if device == "cpu" and mesh == "auto":
            mesh = None
        opt_w = _options(cfg, os.path.join(work, "warmup"))
        # warm-up: one job stopped at the end of its first level with work
        run_args = cfg.get("run_args", {})
        warm = run_job(nvm, opt_w, device, mesh, math.inf, True, False,
                       run_args)
        first_level = warm.first_level
        del warm
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
        rec = dict(seconds=seconds, seed=seed, jobs=[], trace=None,
                   workload=workload, device=device)
        undo = plant() if plant is not None else None
        prof = None
        if trace:
            for _, mod in cell.metrics:
                if hasattr(mod, "install"):
                    mod.install(rec)
            from portbench import tracing
            prof = tracing.start(dev)
        setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        ns0 = time.time_ns()
        close = t0 + seconds
        jobs = []
        # jobs start back to back while the window is open; each one that
        # started runs to its end (its answer is due), at most LATE_S past
        # the close
        while time.perf_counter() < close and len(jobs) != trf.get("jobs"):
            j = len(jobs)
            opt = _options(cfg, os.path.join(work, f"job{j}"))
            job = run_job(nvm, opt, device, mesh, close + LATE_S, False,
                          trace, run_args)
            jobs.append(job)
            if job.cut:
                break
            # a finished job: keep its octree cells and drop the engine
            job.octree = _octree_of(job.engine)
            job.drained = not job.engine.have_work()
            job.stats = dict(job.engine.stats)
            job.delivered = job.engine.n_alive()
            job.engine = None
            gc.collect()
        t_end = jobs[-1].t_end
        window_s = t_end - t0
        last = jobs[-1]
        if last.cut:
            last.cloud = _cloud_of(last.engine)
            last.cloud["final"] = False
            last.stats = dict(last.engine.stats)
            last.delivered = len(last.cloud["center"])
        last.engine = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ns_end = time.time_ns()
        if prof is not None:
            rec["trace"] = tracing.stop(prof, ns0, ns_end, jobs)
        found = forbidden_modules()
        if found:
            raise SystemExit("loaded after the window: " + ", ".join(found))
        peak = 0
        if dev.type == "cuda":
            peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count()))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the delivered clouds: the PLY of every finished job, the cut one
        # as of its cut
        clouds = []
        for j, job in enumerate(jobs):
            if getattr(job, "cloud", None) is None:
                job.cloud = read_ply(os.path.join(work, f"job{j}",
                                                  "patches-final.ply"))
                job.cloud["octree"] = job.octree
                job.cloud["final"] = job.drained
            clouds.append(job.cloud)
        rules = dict(cfg["guarantees"])
        rules["max_angle"] = math.radians(rules.pop("max_angle_deg"))
        verdict = reference.judge(scene, rules, clouds, dev)
        checks = [(k, verdict[k], lim) for k, lim in cell.limit.items()]
        correct = all(v <= lim for _, v, lim in checks)
        rec.update(setup_s=setup_s, window_s=window_s, peak_bytes=peak,
                   jobs=jobs, first_level=first_level,
                   delivered=sum(j.delivered for j in jobs),
                   verdict=verdict, power_limit=_power_limit())
        metrics = {}
        for m, mod in cell.metrics:
            v = mod.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out = dict(correct=bool(correct), attempted=len(jobs),
                   failed=0 if correct else len(jobs), metrics=metrics,
                   device=_device_info(dev, cell.chips, peak, rec))
        if trace and rec["trace"] is not None:
            out["breakdown"] = rec["trace"]["breakdown"]
        out["checks"] = {name: {"value": v, "limit": lim}
                         for name, v, lim in checks}
        out["_verdict"] = verdict
        out["_rec"] = rec
        return out
    finally:
        if undo is not None:
            undo()
        shutil.rmtree(work, ignore_errors=True)


def _power_limit():
    try:
        import subprocess
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _device_info(dev, chips, peak, rec):
    import torch
    if dev.type != "cuda":
        info = dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    else:
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=chips, memory_peak_bytes=int(peak))
    tr = rec.get("trace")
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info
