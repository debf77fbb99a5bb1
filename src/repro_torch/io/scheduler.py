"""Read scheduling for the disk tier (KVSwap §3.4.4).

The predictor emits an unordered set of group ids; the device wants few,
large, sequential requests (Fig. 2: effective bandwidth collapses below ~6 %
of peak for small random reads).  :class:`ReadScheduler` turns a miss list
into an ordered *plan* of coalesced runs:

1. sort and de-duplicate the requested group ids,
2. merge **adjacent** ids into one contiguous run (one sequential read),
3. optionally read *through* small gaps (``max_gap`` groups) when streaming
   the gap bytes is cheaper than paying another per-request latency — the
   classic elevator/deadline trade on NAND storage.

The scheduler is pure (no I/O, no locks): it only plans.  ``KVDiskStore``
executes runs via :meth:`~repro.core.offload.KVDiskStore.read_run`, charging
the :class:`~repro.core.offload.IOAccountant` one request per run.  Purity
extends to observability: the scheduler publishes nothing itself — callers
(:class:`~repro.core.manager.KVCacheManager`) feed :meth:`ReadScheduler.
stats` of each plan into the metrics registry (``kvswap_read_plan_*``), so
planning stays trivially unit-testable.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadRun:
    """One contiguous disk request covering ``[start, start + count)`` groups.

    ``ids`` are the *requested* group ids inside the run (sorted).  When gap
    coalescing is on, ``count`` may exceed ``len(ids)``: the extra groups are
    read and discarded, trading bytes for requests.
    """

    start: int
    count: int
    ids: tuple[int, ...]

    @property
    def stop(self) -> int:
        return self.start + self.count

    def waste(self) -> int:
        """Number of gap groups read but not requested."""
        return self.count - len(self.ids)


class ReadScheduler:
    """Sort + coalesce group-read requests into large sequential runs.

    ``max_gap`` is the largest run of *unrequested* groups the scheduler will
    read through to keep a request sequential.  ``max_gap=0`` (default)
    merges only strictly adjacent ids — byte counts then exactly equal the
    requested payload, which is what the accounting tests pin down.
    """

    def __init__(self, max_gap: int = 0):
        if max_gap < 0:
            raise ValueError(f"max_gap must be >= 0, got {max_gap}")
        self.max_gap = max_gap

    @classmethod
    def from_spec(cls, spec, group_nbytes: int) -> "ReadScheduler":
        """Pick ``max_gap`` from device characteristics: reading a gap group
        is worthwhile while its streaming time stays under the per-request
        latency (``gap · group_nbytes / peak_bw < request_latency``)."""
        if group_nbytes <= 0:
            return cls(0)
        max_gap = int(spec.request_latency * spec.peak_bw // group_nbytes)
        return cls(max_gap=max_gap)

    def plan(self, group_ids: Iterable[int]) -> list[ReadRun]:
        """Plan coalesced runs for a set of group ids (any order, dups ok)."""
        ids = sorted({int(g) for g in group_ids})
        if not ids:
            return []
        runs: list[ReadRun] = []
        run_start = ids[0]
        run_ids = [ids[0]]
        for g in ids[1:]:
            gap = g - run_ids[-1] - 1
            if gap <= self.max_gap:
                run_ids.append(g)
            else:
                runs.append(ReadRun(run_start, run_ids[-1] - run_start + 1,
                                    tuple(run_ids)))
                run_start = g
                run_ids = [g]
        runs.append(ReadRun(run_start, run_ids[-1] - run_start + 1, tuple(run_ids)))
        return runs

    def run_lengths(self, ids: np.ndarray) -> np.ndarray:
        """The ``count`` of each run :meth:`plan` makes of sorted, distinct
        ``ids``, in numpy, without a :class:`ReadRun` a run.  A run breaks
        where the step between neighbouring ids leaves a gap wider than
        ``max_gap``."""
        if not ids.size:
            return ids[:0]
        cut = np.flatnonzero(np.diff(ids) > self.max_gap + 1) + 1
        return ids[np.append(cut - 1, ids.size - 1)] - ids[np.insert(cut, 0, 0)] + 1

    def stats(self, plan: Sequence[ReadRun]) -> dict:
        """Summary counters for a plan (used by tests and benchmarks)."""
        return {
            "requests": len(plan),
            "groups_requested": sum(len(r.ids) for r in plan),
            "groups_read": sum(r.count for r in plan),
            "groups_wasted": sum(r.waste() for r in plan),
        }
