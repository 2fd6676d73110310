"""The copy kernels' share of their bandwidth bound: the bytes their
launches in the window need (portbench/kernel_bytes.py, counted from each
launch's sizes) over 3.35 TB/s, divided by their summed device time
(csrc/fetch.cu, score.cu, permute.cu)."""

from portbench import kernel_bytes, tracing

KERNELS = ("fetch_windows_kernel", "sample_views_kernel",
           "permute_windows_kernel")


def install(rec):
    rec["kernel_sizes"] = kernel_bytes.capture()


def read(rec):
    tr, cap = rec["trace"], rec.get("kernel_sizes")
    if not tr or cap is None:
        return None
    ns = sum(tracing.kernel_ns(tr, k) for k in KERNELS)
    nbytes = cap.total_bytes()
    if not ns or not nbytes:
        return None
    return 100.0 * (nbytes / kernel_bytes.HBM_BYTES_PER_S) / (ns / 1e9)
