"""Device time of the GN kernel (exact and FD modes, csrc/gn.cu) per
1,000 refined patches (engine stats patches_optimized)."""

from portbench import tracing


def read(rec):
    tr = rec["trace"]
    n = sum(j.stats.get("patches_optimized", 0) for j in rec["jobs"])
    if not tr or not n:
        return None
    ns = tracing.kernel_ns(tr, "gn_refine_kernel")
    return (ns / 1e6) / (n / 1000.0) if ns else None
