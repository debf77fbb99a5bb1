"""Summed wall time a decode step of the window of the prefetch workers'
``fetch`` spans, in ms: the fetch work done beside the main thread (set it
against ``io_wait_ms``, the part the main thread waited for)."""


def read(rec):
    ph = rec.get("phases") or {}
    steps = len(rec["step_wall_s"])
    if ph.get("fetch_busy_s") is None or not steps:
        return None
    return 1e3 * ph["fetch_busy_s"] / steps
