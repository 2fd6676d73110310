"""The port's native PLY formatter (native/ply_ascii.cpp through
hpmvs_tpu_torch/core/native.py and io/ply.py) alone: every float32 written
as repr(float(x)), the text the Python writer's f-strings gave, on random
bit patterns, normals and the edges of Python's layout; the writer's
guards and the formatter's build."""

import numpy as np
import pytest

from hpmvs_tpu_torch.core import native
from hpmvs_tpu_torch.io import ply as pply

EDGES = [     # (value, its text)
    (0.0, "0.0"), (-0.0, "-0.0"), (np.inf, "inf"), (-np.inf, "-inf"),
    (1.4e-45, "1.401298464324817e-45"), (-1.4e-45, "-1.401298464324817e-45"),
    (3.4028235e38, "3.4028234663852886e+38"),
    (-3.4028235e38, "-3.4028234663852886e+38"),
    (1.1754944e-38, "1.1754943508222875e-38"),
    (1e-4, "9.999999747378752e-05"), (1e-5, "9.999999747378752e-06"),
    (0.0001220703125, "0.0001220703125"),
    (6.103515625e-05, "6.103515625e-05"),
    (0.000999999, "0.0009999989997595549"), (1e15, "999999986991104.0"),
    (1e16, "1.0000000272564224e+16"), (2.0 ** 49, "562949953421312.0"),
    (2.0 ** 53, "9007199254740992.0"), (2.0 ** 54, "1.8014398509481984e+16"),
    (1.0, "1.0"), (-1.0, "-1.0"), (123456789.0, "123456792.0"), (0.5, "0.5"),
    (0.1, "0.10000000149011612"), (-2.5e-3, "-0.0024999999441206455"),
    (100.0, "100.0"), (-16777216.0, "-16777216.0"), (3.0e7, "30000000.0"),
]


def _python(x):
    return "".join(repr(v) + "\n" for v in x.tolist()).encode()


def _native(x, tmp_path):
    """The writer's text of float32 values, one per line: written as the
    centres of rows (x y z 0 0 0), read back with the colours cut off."""
    x = np.asarray(x, np.float32)
    pad = -len(x) % 3
    c = np.concatenate([x, np.zeros(pad, np.float32)]).reshape(-1, 3)
    n = len(c)
    path = tmp_path / "floats.ply"
    pply.write_ext_ply(str(path), c, c, np.zeros((n, 3)),
                       np.zeros(n, np.float32), normal=False, scale=False)
    body = path.read_bytes().split(b"end_header\n", 1)[1]
    assert body.endswith(b" 0 0 0 \n") or n == 0
    vals = body.replace(b" 0 0 0 \n", b" ").split(b" ")[:len(x)]
    return b"".join(v + b"\n" for v in vals)


def test_float_text_edges(tmp_path):
    """Both notations on each side of Python's switches (the point in
    (-4, 16]), whole numbers, signed zeros and infinities, the smallest
    subnormal, FLT_MAX and the smallest normal."""
    x = np.array([v for v, _ in EDGES], np.float32)
    want = "".join(t + "\n" for _, t in EDGES).encode()
    assert _python(x) == want
    assert _native(x, tmp_path) == want
    nans = np.array([np.nan, -np.nan, np.float32(np.nan) * -1], np.float32)
    assert _native(nans, tmp_path) == b"nan\nnan\nnan\n"


def test_float_text_on_random_bit_patterns(tmp_path):
    """A million float32 bit patterns (subnormals, nans and infinities
    among them), then 200,000 normals: the same text as Python."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    got, want = _native(x, tmp_path), _python(x)
    if got != want:
        g, w = got.split(b"\n"), want.split(b"\n")
        bad = [(x[i], g[i], w[i]) for i in range(len(w)) if g[i] != w[i]]
        raise AssertionError(f"{len(bad)} differ, first {bad[:5]}")
    y = rng.normal(0, 50, 200_000).astype(np.float32)
    assert _native(y, tmp_path) == _python(y)


def test_nviews_outside_0_to_K_raises(tmp_path):
    n = 3
    args = [np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32),
            np.zeros((n, 3)), np.ones(n, np.float32),
            np.zeros((n, 2), np.int32)]
    for nv in ([0, 3, 1], [0, -1, 1]):
        with pytest.raises(ValueError, match="nviews"):
            pply.write_ext_ply(str(tmp_path / "x.ply"), *args,
                               np.array(nv))


def test_mismatched_shapes_raise(tmp_path):
    """The formatter reads every array through a raw pointer: a short one
    raises before it is read."""
    n = 4
    good = [np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32),
            np.zeros((n, 3)), np.ones(n, np.float32),
            np.zeros((n, 2), np.int32), np.ones(n, np.int32)]
    for j, short in ((1, np.zeros((n - 1, 3))), (2, np.zeros((n, 2))),
                     (3, np.ones(n + 1)), (4, np.zeros(n, np.int32)),
                     (5, np.ones(n - 1, np.int32))):
        args = list(good)
        args[j] = short
        with pytest.raises(ValueError, match="shape"):
            pply.write_ext_ply(str(tmp_path / "x.ply"), *args)


def test_failed_formatter_build_raises(tmp_path, monkeypatch):
    """The formatter is built with the octree queries; its compiler error
    raises, and nothing falls back to Python."""
    bad = tmp_path / "ply_ascii.cpp"
    bad.write_text("extern \"C\" long ply_format_floats( { return 0; }\n")
    monkeypatch.setattr(native, "PLY_SOURCE", bad)
    with pytest.raises(RuntimeError, match="build failed") as e:
        native.build(tmp_path / "build")
    assert "ply_ascii.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
