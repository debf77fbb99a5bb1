"""The device memory allocated at its highest over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(rec):
    return rec["peak_window_bytes"] / 2**30 if rec["on_card"] and rec["peak_window_bytes"] else None
