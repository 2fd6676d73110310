"""Device dispatches of the wave scheduler per 1,000 delivered patches."""


def read(rec):
    n = sum(j.stats.get("dispatches", 0) for j in rec["jobs"])
    return 1000.0 * n / rec["delivered"] if rec["delivered"] else None
