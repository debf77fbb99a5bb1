"""Device time a decode step of the window of the operations launched from the
fetch tiers' phases (``upload``, ``spill``, ``flush``: the read groups' copies to
the card), in ms."""

from kvbench.phase_reduce import per_step_ms


def read(rec):
    return per_step_ms(rec, "fetch", "device_s")
