"""90th percentile of the gap between consecutive output tokens of one
request, over every gap that ends in the window (host clock, each step
ended by a synchronise).  The 90th and not the 95th: the slowest cell's
window holds about 120 gaps, and a percentile needs ten beyond it."""

import numpy as np


def read(rec):
    return float(np.percentile(rec["itl_s"], 90)) * 1e3 if rec["itl_s"] else None
