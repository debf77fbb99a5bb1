"""Mean per decode step of the engine's measured wait on group reads
(``StepStats.io_wait_seconds``) over the window's steps."""


def read(rec):
    w = rec["io_wait_s"]
    return sum(w) / len(w) * 1e3 if w else None
