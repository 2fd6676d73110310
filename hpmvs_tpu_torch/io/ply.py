"""PLY point-cloud writers.

Equivalent of the reference DynOctTree::toExtPly (include/hpmvs/doctree.h:526-622)
-- xyz, optional normals, uchar rgb, optional scalar_scale, optional
per-point camera-visibility list element -- in ASCII or native-endian binary.

Operates on the engine's patch structure-of-arrays (numpy on host), so export
is a single vectorized dump instead of a tree walk. The ASCII text comes from
the native formatter (native/ply_ascii.cpp, through core/native.py): each
float32 as repr(float(x)), up to 17 digits, byte for byte what the JAX
package's writer prints; the binary body is one packed record array and one
uint32 array of the visibility runs.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import native

# rows a native formatter call writes into the reused buffer
BLOCK = 65536


def write_ext_ply(
    path: str,
    centers: np.ndarray,          # (N, 3) float32
    normals: np.ndarray,          # (N, 3) float32
    colors: np.ndarray,           # (N, 3) float-valued 0..255
    scales: np.ndarray,           # (N,) float32
    views: np.ndarray = None,     # (N, K) int32, -1 padded
    nviews: np.ndarray = None,    # (N,) int32
    binary: bool = False,
    normal: bool = True,
    scale: bool = True,
    visibility: bool = True,
) -> None:
    n = int(centers.shape[0])
    if views is None:
        visibility = False

    hdr = ["ply"]
    if binary:
        endian = "big" if sys.byteorder == "big" else "little"
        hdr.append(f"format binary_{endian}_endian 1.0")
    else:
        hdr.append("format ascii 1.0")
    hdr.append(f"element vertex {n}")
    hdr += ["property float x", "property float y", "property float z"]
    if normal:
        hdr += ["property float nx", "property float ny", "property float nz"]
    hdr += ["property uchar red", "property uchar green", "property uchar blue"]
    if scale:
        hdr.append("property float scalar_scale")
    if visibility:
        hdr.append(f"element point_visibility {n}")
        hdr.append("property list uint uint visible_cameras")
    hdr.append("end_header")

    col_u8 = np.ascontiguousarray(
        np.clip(np.asarray(colors), 0, 255).astype(np.uint8))
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    normals = np.ascontiguousarray(normals, dtype=np.float32)
    scales = np.ascontiguousarray(scales, dtype=np.float32)
    # the native formatter reads these shapes through raw pointers
    want = [("centers", centers, (n, 3)), ("colors", col_u8, (n, 3))]
    if normal:
        want.append(("normals", normals, (n, 3)))
    if scale:
        want.append(("scales", scales, (n,)))
    if visibility:
        views = np.ascontiguousarray(views, dtype=np.int32)
        nviews = np.ascontiguousarray(nviews, dtype=np.int32)
        want += [("views", views, (n, views.shape[-1])),
                 ("nviews", nviews, (n,))]
    for name, a, shape in want:
        if a.shape != shape:
            raise ValueError(f"write_ext_ply: {name} has shape {a.shape}, "
                             f"not {shape}")
    if visibility and n and (nviews.min() < 0
                             or nviews.max() > views.shape[1]):
        raise ValueError("write_ext_ply: nviews outside 0..K")

    with open(path, "wb" if binary else "w") as fh:
        header_text = "\n".join(hdr) + "\n"
        fh.write(header_text.encode() if binary else header_text)
        if binary:
            _write_binary(fh, centers, normals, col_u8, scales, views,
                          nviews, normal, scale, visibility)
        else:
            _write_ascii(fh, centers, normals, col_u8, scales, views,
                         nviews, normal, scale, visibility)


def _write_binary(fh, centers, normals, col_u8, scales, views, nviews,
                  normal, scale, visibility):
    """One packed vertex record per row, then one uint32 run of
    [k, views[:k]...] per row."""
    n = centers.shape[0]
    fields = [("c", np.float32, (3,))]
    if normal:
        fields.append(("n", np.float32, (3,)))
    fields.append(("rgb", np.uint8, (3,)))
    if scale:
        fields.append(("s", np.float32))
    rec = np.empty(n, np.dtype(fields))
    rec["c"] = centers
    if normal:
        rec["n"] = normals
    rec["rgb"] = col_u8
    if scale:
        rec["s"] = scales
    fh.write(rec.tobytes())
    if visibility:
        runs = np.empty((n, views.shape[1] + 1), np.uint32)
        runs[:, 0] = nviews
        runs[:, 1:] = views.astype(np.uint32)
        keep = np.arange(runs.shape[1]) <= nviews[:, None]
        fh.write(runs[keep].tobytes())


def _write_ascii(fh, centers, normals, col_u8, scales, views, nviews,
                 normal, scale, visibility):
    """The rows in blocks of BLOCK, each formatted by one native call into
    one reused buffer and written with one write."""
    n = centers.shape[0]
    if n == 0:
        fh.write("\n")
        return
    h = native.lib()
    b = min(n, BLOCK)
    buf = np.empty(b * 256, np.uint8)
    for i0 in range(0, n, b):
        m = h.ply_format_vertices(i0, min(i0 + b, n), centers, normals,
                                  col_u8, scales, int(normal), int(scale),
                                  buf)
        fh.write(str(buf[:m], "ascii"))
    if visibility:
        k = views.shape[1]
        buf = np.empty(b * (12 * (k + 1) + 2), np.uint8)
        for i0 in range(0, n, b):
            m = h.ply_format_visibility(i0, min(i0 + b, n), k, views,
                                        nviews, buf)
            fh.write(str(buf[:m], "ascii"))


def read_ext_ply(path: str):
    """Read a PLY written by write_ext_ply (ASCII or binary, any property
    subset). Returns a dict with keys 'xyz' (N,3) f32, and -- when present --
    'normals' (N,3) f32, 'colors' (N,3) uint8, 'scales' (N,) f32,
    'visibility' (list of int arrays)."""
    with open(path, "rb") as fh:
        assert fh.readline().strip() == b"ply"
        binary = False
        endian = "<"
        n = nvis = 0
        props = []          # vertex property names in order
        in_vertex = False
        while True:
            line = fh.readline().strip().decode()
            if line.startswith("format"):
                binary = "binary" in line
                endian = ">" if "big" in line else "<"
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element point_visibility"):
                nvis = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                toks = line.split()
                props.append((toks[-1], toks[1]))
            elif line == "end_header":
                break

        fields = [(name, (np.uint8 if typ == "uchar"
                          else np.dtype(endian + "f4")))
                  for name, typ in props]
        dt = np.dtype(fields)
        if binary:
            rec = np.frombuffer(fh.read(n * dt.itemsize), dtype=dt, count=n)
            vis = []
            for _ in range(nvis):
                k = int(np.frombuffer(fh.read(4),
                                      dtype=np.dtype(endian + "u4"))[0])
                vis.append(np.frombuffer(fh.read(4 * k),
                                         dtype=np.dtype(endian + "u4")
                                         ).astype(np.int64))
        else:
            rows = [fh.readline().split() for _ in range(n)]
            rec = np.zeros(n, dtype=dt)
            for j, (name, _) in enumerate(fields):
                col = np.array([float(r[j]) for r in rows])
                rec[name] = col
            vis = []
            for _ in range(nvis):
                toks = [int(t) for t in fh.readline().split()]
                vis.append(np.asarray(toks[1:1 + toks[0]], dtype=np.int64))

        names = [f[0] for f in fields]
        out = {"xyz": np.stack([rec["x"], rec["y"], rec["z"]],
                               axis=1).astype(np.float32)}
        if "nx" in names:
            out["normals"] = np.stack([rec["nx"], rec["ny"], rec["nz"]],
                                      axis=1).astype(np.float32)
        if "red" in names:
            out["colors"] = np.stack([rec["red"], rec["green"], rec["blue"]],
                                     axis=1).astype(np.uint8)
        if "scalar_scale" in names:
            out["scales"] = np.asarray(rec["scalar_scale"], dtype=np.float32)
        if nvis:
            out["visibility"] = vis
        return out


def read_ply_xyz(path: str) -> np.ndarray:
    """Minimal ASCII PLY reader for tests: returns the (N,3) xyz block."""
    with open(path, "r") as fh:
        line = fh.readline().strip()
        assert line == "ply"
        n = 0
        props = 0
        in_vertex = False
        while True:
            line = fh.readline().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                props += 1
            elif line == "end_header":
                break
        out = np.zeros((n, 3), dtype=np.float64)
        for ii in range(n):
            vals = fh.readline().split()
            out[ii] = [float(v) for v in vals[:3]]
        return out
