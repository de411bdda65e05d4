"""Host milliseconds of one occupancy update (the sweep and the skip-grid
rebuild), synchronized before and after, averaged over the traced window's
updates."""


def read(r):
    ms = r.counters.get("update_ms")
    return sum(ms) / len(ms) if ms else None
