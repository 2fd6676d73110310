"""ctypes binding for the port's native host library: the octree queries
(native/octree_core.cpp) and the ASCII PLY formatter (native/ply_ascii.cpp).

The reference's octree and scheduler bookkeeping is C++ (doctree.h,
CellProcessor.cpp); native/octree_core.cpp is the same hot path for the
linear Morton octree of core/octree.py: batched Morton keys, the
derived-structure queries (structure level, containing cell, exact lookup)
and the seed conflict push-down. Its answers are integers, bit-identical to
the numpy path, which stays in core/octree.py as the library's twin.
native/ply_ascii.cpp formats the PLY writer's text (io/ply.py) byte for
byte as the Python writer's f-strings did.

The library is compiled from both sources at first use (the engine's
constructor) with `g++ -O3 -shared -fPIC` into the git-ignored build/
directory beside build/'s CUDA kernels, under a name that hashes the
sources and the flags;
concurrent builds (test workers) write to their own temporary names and
rename into place, so no process loads a half-written library. A failed
build raises with the compiler's output. The prebuilt native/*.so is never
loaded: it is compiled for one host's CPU (-march=native).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "octree_core.cpp"
PLY_SOURCE = ROOT / "native" / "ply_ascii.cpp"
BUILD = ROOT / "build"
FLAGS = ["-O3", "-shared", "-fPIC"]

# above this many queries one argsort and a merge sweep per level beat a
# binary search per query (native/octree_core.cpp, *_sorted)
SORT_THRESHOLD = 4096

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_f64 = ctypes.c_double


class _Lib:
    handle = None
    path = None


def build(build_dir: Path = BUILD) -> Path:
    """Compile native/octree_core.cpp and native/ply_ascii.cpp into one
    library in build_dir (skipped when a library built from the same
    sources and flags is there). Returns its path."""
    sources = (SOURCE, PLY_SOURCE)
    digest = hashlib.sha1()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(repr(FLAGS).encode())
    out = Path(build_dir) / f"libhpmvs_native-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native library: g++ not found")
    res = subprocess.run([cxx, *FLAGS, *map(str, sources), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library: the build failed "
                           f"(exit {res.returncode}):\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def lib(path=None) -> ctypes.CDLL:
    """The loaded library (built on first call; `path` loads another
    build of it, as the tests do)."""
    if _Lib.handle is not None and path is None:
        return _Lib.handle
    p = Path(path) if path is not None else build()
    h = ctypes.CDLL(str(p))
    h.morton_encode.argtypes = [_i64, _i64p, _i64p, _i64p, _u64p]
    h.keys_at_level.argtypes = [_i64, _f64p, _f64, _f64, _f64, _f64, _i64,
                                _u64p]
    h.structure_level.argtypes = [_i64, _u64p, _i64, _u64p, _i64p, _i64p]
    h.structure_level_sorted.argtypes = h.structure_level.argtypes
    h.containing_cell.argtypes = [_i64, _u64p, _i64, _u64p, _i64p, _i64p,
                                  _i64p]
    h.containing_cell_sorted.argtypes = h.containing_cell.argtypes
    h.lookup_cells.argtypes = [_i64, _i64p, _u64p, _i64, _u64p, _i64p, _i64p,
                               _i64p]
    h.seed_pushdown.argtypes = [_i64, _f64p, _f64, _f64, _f64, _f64, _i64,
                                _i64p, _u64p]
    h.seed_pushdown.restype = _i64
    for name in ("morton_encode", "keys_at_level", "structure_level",
                 "structure_level_sorted", "containing_cell",
                 "containing_cell_sorted", "lookup_cells"):
        getattr(h, name).restype = None
    h.ply_format_vertices.argtypes = [_i64, _i64, _f32p, _f32p, _u8p, _f32p,
                                      _i64, _i64, _u8p]
    h.ply_format_visibility.argtypes = [_i64, _i64, _i64, _i32p, _i32p,
                                        _u8p]
    h.ply_format_vertices.restype = _i64
    h.ply_format_visibility.restype = _i64
    if path is None:
        _Lib.handle, _Lib.path = h, p
    return h


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def morton_encode(ix, iy, iz):
    n = len(ix)
    out = np.empty(n, np.uint64)
    lib().morton_encode(n, _c(ix, np.int64), _c(iy, np.int64),
                        _c(iz, np.int64), out)
    return out


def keys_at_level(pts, center, width, level):
    """Morton keys at `level` of points (n, 3) in the cube (center, width)."""
    n = pts.shape[0]
    out = np.empty(n, np.uint64)
    lib().keys_at_level(n, _c(pts, np.float64), float(center[0]),
                        float(center[1]), float(center[2]), float(width),
                        int(level), out)
    return out


def _sorted_query(fn, fn_sorted, q, *tables):
    """Run a per-query function, or for large batches its merge-sweep
    variant on the queries sorted by key (answers scattered back)."""
    n = len(q)
    q = _c(q, np.uint64)
    out = np.empty(n, np.int64)
    if n >= SORT_THRESHOLD:
        order = np.argsort(q, kind="stable")
        fn_sorted(n, _c(q[order], np.uint64), *tables, out)
        inv = np.empty(n, np.int64)
        inv[order] = out
        return inv
    fn(n, q, *tables, out)
    return out


def structure_level(qkeys_max, max_level, anc_flat, anc_off):
    """1 + the deepest level whose ancestor set holds each query's key at
    that level (0 when none); qkeys_max are keys at max_level."""
    h = lib()
    return _sorted_query(h.structure_level, h.structure_level_sorted,
                         qkeys_max, int(max_level), _c(anc_flat, np.uint64),
                         _c(anc_off, np.int64))


def containing_cell(qkeys_max, max_level, occ_flat, occ_off, occ_cid):
    """Occupied cell id holding each query (keys at max_level), or -1."""
    h = lib()
    return _sorted_query(h.containing_cell, h.containing_cell_sorted,
                         qkeys_max, int(max_level), _c(occ_flat, np.uint64),
                         _c(occ_off, np.int64), _c(occ_cid, np.int64))


def lookup_cells(qlevels, qkeys, max_level, occ_flat, occ_off, occ_cid):
    """Cell id of each exact (level, key) pair, or -1."""
    n = len(qkeys)
    out = np.empty(n, np.int64)
    lib().lookup_cells(n, _c(qlevels, np.int64), _c(qkeys, np.uint64),
                       int(max_level), _c(occ_flat, np.uint64),
                       _c(occ_off, np.int64), _c(occ_cid, np.int64), out)
    return out


def seed_pushdown(pts, center, width, max_level, levels):
    """Seed conflict push-down (doctree.h:378-394 split semantics): levels
    deepened until no seed's cell is an ancestor of another seed's cell.
    Returns (levels, keys at those levels)."""
    n = pts.shape[0]
    io_levels = _c(levels, np.int64).copy()
    out_keys = np.empty(n, np.uint64)
    lib().seed_pushdown(n, _c(pts, np.float64), float(center[0]),
                        float(center[1]), float(center[2]), float(width),
                        int(max_level), io_levels, out_keys)
    return io_levels, out_keys
