"""Median wall of one ``ServeSession.step()`` in the window, ended by a
synchronise."""

import statistics


def read(rec):
    return statistics.median(rec["step_wall_s"]) * 1e3 if rec["step_wall_s"] else None
