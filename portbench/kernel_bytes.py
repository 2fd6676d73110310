"""Bytes the copy kernels must move, counted from each launch's sizes: a
frozen copy of hpmvs_tpu_torch/kernel_check.py's rules (each input byte
read once, each output byte written once), extended to the masked and
`prev` fetches the main path makes. Peaks: one H100 SXM, NVIDIA's data
sheet.

fetch (csrc/fetch.cu): a live pair reads its W x W x 3 float window from
  the pyramid; every pair writes its window; a masked-off pair reads its
  `prev` window when given one (else it writes zeros); plus the int32 row
  and column of every pair and the mask's byte.
score (csrc/score.cu): its geometry (6 floats) and window per (patch,
  view) in, the 49 x 3 sampled texture and, when asked for, the centre
  colour out.
permute (csrc/permute.cu): the windows in, the int32 order in, the
  permuted windows out.

`capture()` wraps the three kernel wrappers of the program (traced runs
only) and records each CUDA launch's sizes; the fetch masks are kept and
counted once the window has closed, so the capture adds no device work
inside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32 = 4


class Capture:
    def __init__(self):
        self.fixed = 0            # bytes known at launch
        self.masks = []           # (mask tensor, per-live bytes)

    def total_bytes(self) -> int:
        live = sum(int(m.sum()) * per for m, per in self.masks)
        return self.fixed + live


def fetch_bytes(n, W, masked, has_prev, n_live):
    win = W * W * 3 * F32
    b = n_live * win + n * win + 2 * n * 4
    if masked:
        b += n
        if has_prev:
            b += (n - n_live) * win
    return b


def score_bytes(B, K, W, with_color):
    b = B * K * (6 * F32 + W * W * 3 * F32 + 49 * 3 * F32)
    return b + (B * K * 3 * F32 if with_color else 0)


def permute_bytes(B, K, W):
    return 2 * B * K * W * W * 3 * F32 + B * K * 4


def capture() -> Capture:
    from hpmvs_tpu_torch.ops import fetch, score
    cap = Capture()
    f0, s0, p0 = fetch.fetch_windows, score.sample_windows, \
        score.permute_windows

    def fetch_windows(tex, rows, ox, W, mask=None, prev=None):
        if tex.is_cuda:
            n = rows.shape[0]
            win = W * W * 3 * F32
            if mask is None:
                cap.fixed += fetch_bytes(n, W, False, False, n)
            else:
                # masked-off pairs: prev read (if any) and output written;
                # live pairs add a window read and lose the prev read
                cap.fixed += fetch_bytes(n, W, True, prev is not None, 0)
                cap.masks.append((mask, win if prev is None else 0))
        return f0(tex, rows, ox, W, mask=mask, prev=prev)

    def sample_windows(geom, win, with_color=False):
        if geom.is_cuda:
            B, K = geom.shape[:2]
            cap.fixed += score_bytes(B, K, win.shape[2], with_color)
        return s0(geom, win, with_color)

    def permute_windows(win, order):
        if win.is_cuda:
            B, K, W = win.shape[:3]
            cap.fixed += permute_bytes(B, K, W)
        return p0(win, order)

    fetch.fetch_windows = fetch_windows
    score.sample_windows = sample_windows
    score.permute_windows = permute_windows
    return cap
