"""Median wall of the set-up's document admissions (``KVSwapEngine.admit_row``:
prefill, KV written to the store, compressed keys), each ended by a
synchronise."""

import statistics


def read(rec):
    return statistics.median(rec["admit_s"]) * 1e3 if rec["admit_s"] else None
