"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with nvcc for sm_90a into one shared
library with a plain C interface under <repo>/build/, and bound with ctypes:
one nvcc per source, all started together, then one link. gn.cu and
select.cu compile without fused multiply-add contraction (SOURCE_FLAGS):
their kernels then round every operation as their plain PyTorch twins do,
which the FD/Broyden mode needs to be comparable at all (its trajectories
are chaotic: a 1e-7 change of rho moves a few percent of them within four
rounds), and view selection to pick the twin's views.
Nothing is compiled at import time: the CPU tests import every module, and a
CPU tensor never reaches a kernel (each wrapper runs its plain PyTorch twin
for CPU tensors instead).

Every C entry point launches on the stream it is given, allocates nothing,
and returns cudaGetLastError() as an int; `launch` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SOURCE_FLAGS = {"gn.cu": ["-fmad=false"], "select.cu": ["-fmad=false"]}


@dataclasses.dataclass
class KernelStats:
    """Launch count of one kernel's wrapper and call count of its twin."""
    launches: int = 0
    twin_calls: int = 0


# one entry per kernel wrapper (name -> counts); chip_smoke.py and the CUDA
# tests reset and read them to show which path a run took
STATS = {name: KernelStats()
         for name in ("fetch", "score", "permute", "gn", "gn_fd",
                      "add_views", "sort_views")}


def reset_counts() -> None:
    for st in STATS.values():
        st.launches = 0
        st.twin_calls = 0


class _Lib:
    handle = None
    path = None
    build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/libhpmvs_kernels-<hash>.so (skipped when
    a library built from the same sources and flags exists). verbose adds
    ptxas register/spill reports to _Lib.build_log."""
    digest = hashlib.sha1()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(repr((ARCH_FLAGS, SOURCE_FLAGS)).encode())
    out = BUILD / f"libhpmvs_kernels-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
    procs, objs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               *SOURCE_FLAGS.get(src.name, []), "-c", "-o", str(obj),
               str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs, failed = [], []
    for name, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    _Lib.build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{_Lib.build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if _Lib.handle is None:
        path = build()
        handle = ctypes.CDLL(str(path))
        for name in ("hpmvs_fetch_windows", "hpmvs_sample_views",
                     "hpmvs_permute_windows", "hpmvs_gn_refine",
                     "hpmvs_gn_refine_fd", "hpmvs_gn_debug_j",
                     "hpmvs_gn_launch_info", "hpmvs_add_views",
                     "hpmvs_sort_views"):
            getattr(handle, name).restype = ctypes.c_int
        _Lib.handle, _Lib.path = handle, path
    return _Lib.handle


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current stream; raise on a launch
    error. Pointers are ctypes.c_void_p, ints ctypes.c_int, floats
    ctypes.c_float; the stream is appended here."""
    fn = getattr(lib(), name)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Wrapper-side argument check before a pointer reaches a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
