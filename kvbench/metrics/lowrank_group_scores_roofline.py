"""Kernel A (``lowrank_group_scores``): its roofline bound summed over the
window's launches (``kvbench/roofline.py``, from each launch's shapes and
valid lengths) over its device time in the profiler's trace, in %."""


def read(rec):
    k = (rec["trace"] or {}).get("kernels", {}).get("lowrank_group_scores", {})
    if not (rec["on_card"] and k.get("launches") and k.get("device_s")):
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
