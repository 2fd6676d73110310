"""Largest torch.cuda.max_memory_allocated() over the cell's devices in
the window (reset when it opens)."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
