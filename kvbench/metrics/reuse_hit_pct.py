"""Share of the group lookups in the window that the reuse buffers served,
summed over the KV layers (``ReuseBuffer.stats``: hits over hits and
misses), in %."""


def read(rec):
    r = rec.get("reuse")
    if not r or not r["hits"] + r["misses"]:
        return None
    return 100.0 * r["hits"] / (r["hits"] + r["misses"])
