"""Wave lookahead: hits over hits plus misses."""


def read(rec):
    h = sum(j.stats.get("lookahead_hits", 0) for j in rec["jobs"])
    m = sum(j.stats.get("lookahead_misses", 0) for j in rec["jobs"])
    return 100.0 * h / (h + m) if h + m else None
