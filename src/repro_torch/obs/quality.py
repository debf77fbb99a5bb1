"""Prefetch-quality accounting: predictor precision/recall and staleness.

ROADMAP item 4 (lookahead prefetch, after HillInfer) needs to know how
predictable the next step's critical-group selection is *before* anyone
builds a predictor for it.  This meter measures exactly that, framed as
1-step lookahead: treat step ``t``'s selection as a "prediction" of step
``t+1``'s and score it when ``t+1`` arrives.

Per (layer, row) the engine reports each step's selected group-id set
``C``; against the previous step's set ``P`` for the same (layer, row):

* ``precision`` — ``|P ∩ C| / |P|``: of the groups a lookahead prefetcher
  would have preloaded, how many were actually wanted;
* ``recall``    — ``|P ∩ C| / |C|``: how much of the step's working set a
  lookahead prefetcher would have had ready;
* ``stale_group_rate`` — of the groups *resident in the reuse buffer* when
  the step selected, the fraction it did **not** select: dead weight a
  smarter eviction policy could reclaim.

The engine stores the pooled integer counts in :class:`~repro.core.engine.
StepStats` (ratios of sums aggregate correctly across layers, rows and
steps; per-step means of ratios would overweight sparse rows), and
``summarize_steps`` reports the window-pooled ratios.

This meter is host-side set arithmetic over a few hundred ints per step —
cheap enough to stay **always on**, and purely observational (it reads the
selection and the reuse residency, mutates neither), so it cannot perturb
the token streams the bit-identity tests pin.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PrefetchQualityMeter", "QualityCounts"]


@dataclasses.dataclass
class QualityCounts:
    """Pooled per-step counts (summed over layers and rows)."""

    shared_groups: int = 0     # |P ∩ C|
    prev_groups: int = 0       # |P|
    cur_groups: int = 0        # |C|
    stale_groups: int = 0      # reuse-resident but unselected
    resident_groups: int = 0   # reuse-resident at selection time


class PrefetchQualityMeter:
    """Accumulates selection overlap step over step, per (layer, row).

    The engine calls :meth:`begin_step` once per decode step,
    :meth:`observe` once per KV layer (with that layer's post-mask
    selection and its reuse buffer), and :meth:`finish_step` to collect the
    pooled counts.  :meth:`clear_row` forgets a retired slot so a recycled
    slot's first step never scores against the previous tenant;
    :meth:`reset` forgets everything (re-prefill).
    """

    def __init__(self):
        # (layer, row) -> frozenset of the last step's selected group ids
        self._prev: dict[tuple[int, int], frozenset] = {}
        self._acc = QualityCounts()

    def begin_step(self) -> None:
        self._acc = QualityCounts()

    def observe(self, layer: int, ids: np.ndarray, mask: np.ndarray,
                reuse=None) -> None:
        """Score one layer's selection: ``ids, mask`` are the ``[B, M]``
        post-mask pair :meth:`KVSwapEngine._predict_for` hands to the
        fetch; ``reuse`` is that layer's :class:`~repro.core.reuse_buffer.
        ReuseBuffer` (``resident()`` supplies the staleness base)."""
        acc = self._acc
        for bi in range(ids.shape[0]):
            row_mask = mask[bi]
            if not row_mask.any():
                continue
            cur = frozenset(int(g) for g in ids[bi][row_mask])
            key = (layer, bi)
            prev = self._prev.get(key)
            if prev is not None:
                inter = len(prev & cur)
                acc.shared_groups += inter
                acc.prev_groups += len(prev)
                acc.cur_groups += len(cur)
            if reuse is not None:
                res = reuse.resident(bi)
                acc.resident_groups += len(res)
                acc.stale_groups += len(res - cur)
            self._prev[key] = cur

    def finish_step(self) -> QualityCounts:
        return self._acc

    def clear_row(self, bi: int) -> None:
        for key in [k for k in self._prev if k[1] == bi]:
            del self._prev[key]

    def reset(self) -> None:
        self._prev.clear()
        self._acc = QualityCounts()
