"""Share of the traced window in which no operation ran on the device, in %."""


def read(rec):
    t = rec["trace"]
    if not (rec["on_card"] and t and t["busy_s"] > 0):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
