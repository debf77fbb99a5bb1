"""The window's peak device allocation less the weights: the KV working set
(compressed keys, reuse-buffer mirrors, rolling tail) and the step's
transients."""


def read(rec):
    if not (rec["on_card"] and rec["peak_window_bytes"]):
        return None
    return (rec["peak_window_bytes"] - rec["param_bytes"]) / 2**20
