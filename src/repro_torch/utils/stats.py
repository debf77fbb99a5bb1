"""Tiny deterministic order statistics shared by the core step summaries
(:func:`repro.core.engine.summarize_steps`) and the serving-side per-request
aggregation (:mod:`repro.serving.metrics`).

One implementation so every report in the repo computes "p95" the same way:
linear interpolation between closest ranks on the sorted sample (numpy's
default ``method="linear"``), written out in pure Python so the result is a
plain float with no dependence on numpy reduction order.
"""

from __future__ import annotations

from typing import Iterable, Sequence

DEFAULT_QS = (50.0, 95.0, 99.0)


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated ``q``-th percentile (0..100) of ``xs``.

    Raises on an empty sample — callers decide what "no data" means rather
    than silently reporting 0 latency.
    """
    if not xs:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def percentiles(xs: Sequence[float], qs: Iterable[float] = DEFAULT_QS) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` (keys follow ``qs``).

    Integer-valued quantiles format without a trailing ``.0`` ("p95", not
    "p95.0").  Empty input returns an empty dict.
    """
    if not xs:
        return {}
    out = {}
    for q in qs:
        key = f"p{int(q)}" if float(q).is_integer() else f"p{q}"
        out[key] = percentile(xs, q)
    return out
