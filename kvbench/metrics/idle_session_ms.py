"""Idle device time a decode step of the window while the main thread was in
the serving session's phases (``serve.*``, the engine step's own time outside
its phases, ``stats``), in ms."""

from kvbench.phase_reduce import per_step_ms


def read(rec):
    return per_step_ms(rec, "session")
