"""Idle device time a decode step of the window while the main thread was in
the decode block's phases (``embed``, ``gather``, ``block``, ``tail``, ``logits``),
in ms."""

from kvbench.phase_reduce import per_step_ms


def read(rec):
    return per_step_ms(rec, "block")
