"""Disk tier: the authoritative KV store behind the :class:`KVTier` verbs.

Wraps one layer's view of the shared :class:`~repro.core.offload.KVDiskStore`
plus everything the old hand-inlined fetch path kept around it:

* the :class:`~repro.io.scheduler.ReadScheduler` run planner (misses are
  sorted and coalesced into sequential runs before touching the store,
  KVSwap §3.4.4) with its run-plan obs counters;
* bounded retry-with-backoff for transient faults
  (:class:`~repro.faults.retry.RetryPolicy`), charging each modeled
  backoff as accountant stall time and escalating exhaustion as the typed
  :class:`~repro.faults.errors.FetchFailed` the serving layer needs to
  fail exactly one request.

One ``DiskTier`` instance is layer-bound (it lives inside that layer's
:class:`~repro.core.manager.KVCacheManager` and keeps the layer's retry
counters), but the verbs still take ``layer`` explicitly per the protocol
— the underlying store is shared, so serving another layer's extent is
well-defined.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.faults.errors import FetchFailed, StorageFault
from repro_torch.faults.retry import RetryPolicy, call_with_retries
from repro_torch.io.scheduler import ReadRun, ReadScheduler
from repro_torch.tiers.base import KVTier

__all__ = ["DiskTier"]


class DiskTier(KVTier):
    """Planner + retry + accounting wrapper over a :class:`KVDiskStore`.

    The store itself charges read/write time through its accountant; this
    wrapper adds the *plan* (coalesced sequential runs) and the *fault
    ladder* (bounded retry, typed escalation) so the chain walker above it
    stays storage-agnostic.
    """

    name = "disk"

    def __init__(self, *, store, layer: int,
                 scheduler: ReadScheduler | None = None,
                 retry: RetryPolicy | None = None, obs=None):
        self.store = store
        self.layer = layer
        self.scheduler = scheduler or ReadScheduler(max_gap=0)
        # None = fail on the first error (no retry budget)
        self.retry = retry
        self.retries = 0          # retried attempts, lifetime
        self.fetch_failures = 0   # runs given up on, lifetime
        self._obs = obs
        if obs is not None and obs.enabled:
            reg = obs.registry
            self._m_plan_requests = reg.counter(
                "kvswap_read_plan_requests_total",
                "coalesced sequential runs planned by ReadScheduler")
            self._m_plan_groups = reg.counter(
                "kvswap_read_plan_groups_read_total",
                "groups read by planned runs (requested + gap)")
            self._m_plan_wasted = reg.counter(
                "kvswap_read_plan_groups_wasted_total",
                "gap groups read through but not requested")
            self._m_batched = reg.counter(
                "kvswap_fetch_batched_groups_total",
                "groups served by the batched fetch (one gather a layer)")
            self._m_retries = reg.counter(
                "kvswap_io_retries_total",
                "disk read attempts retried after a transient fault")
            self._m_fetch_failures = reg.counter(
                "kvswap_io_fetch_failures_total",
                "group runs unrecoverable after the retry budget")

    def charge_rows(self, rows: np.ndarray, gids: np.ndarray) -> None:
        """Charge the reads :meth:`serve_run` would make of each row's
        misses, for a fetch that gathers the groups itself
        (``KVCacheManager.fetch``'s batched path): the same runs, each one
        request, row after row, and the same plan counters.  ``gids``
        ascend within each row, rows ascend.  Nothing is read here, so
        nothing is retried."""
        # rows spaced past the largest gap a run may read through: one plan,
        # and no run crosses from one row into the next
        span = self.store.max_groups + self.scheduler.max_gap + 1
        counts = self.scheduler.run_lengths(rows * span + gids)
        acc = getattr(self.store, "accountant", None)
        if acc is not None:
            acc.charge_reads(counts * self.store.group_nbytes)
        if self._obs is not None and self._obs.enabled:
            read = int(counts.sum())
            self._m_plan_requests.inc(counts.size)
            self._m_plan_groups.inc(read)
            self._m_plan_wasted.inc(read - gids.size)
            self._m_batched.inc(gids.size)

    # -- the retrying read primitive --------------------------------------
    def read_run_with_retry(self, batch_idx: int, run: ReadRun,
                            layer: int | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Execute one coalesced run with bounded retry-with-backoff.

        Transient faults are retried per ``self.retry`` with each modeled
        backoff delay charged as accountant stall time — inside the active
        ``track()`` scope, so retries show up in the same per-step
        ``io_seconds`` as the read itself.  Anything unrecoverable
        (persistent media errors, an exhausted budget, a real ``OSError``)
        escalates as :class:`FetchFailed` carrying the (layer, row, run)
        the serving layer needs to fail exactly one request."""
        lyr = self.layer if layer is None else layer
        read = lambda: self.store.read_run(lyr, batch_idx,
                                           run.start, run.count)
        try:
            if self.retry is None:
                return read()
            acc = getattr(self.store, "accountant", None)

            def backoff(delay: float) -> None:
                self.retries += 1
                if self._obs is not None and self._obs.enabled:
                    self._m_retries.inc()
                if acc is not None:
                    acc.charge_stall(delay)

            return call_with_retries(read, policy=self.retry,
                                     on_backoff=backoff)
        except (StorageFault, OSError) as exc:
            self.fetch_failures += 1
            if self._obs is not None and self._obs.enabled:
                self._m_fetch_failures.inc()
            raise FetchFailed(
                f"layer {lyr} row {batch_idx} groups "
                f"[{run.start},{run.start + run.count}) unrecoverable: {exc}",
                layer=lyr, row=batch_idx, start=run.start,
                count=run.count) from exc

    # -- KVTier verbs ------------------------------------------------------
    def lookup(self, layer: int, row: int,
               gids: Sequence[int]) -> list[int]:
        ng = int(self.store.n_groups[layer, row])
        return [int(g) for g in gids if int(g) < ng]

    def serve(self, layer: int, row: int, gid: int,
              dtype) -> np.ndarray | None:
        if int(gid) >= int(self.store.n_groups[layer, row]):
            return None
        return self.read_run_with_retry(
            row, ReadRun(int(gid), 1, (int(gid),)), layer=layer).block[0]   # [G, 2, Hkv, d]

    def serve_run(self, layer: int, row: int, gids: Sequence[int],
                  dtype) -> tuple[list[tuple[int, np.ndarray]], list[int]]:
        """Plan misses into sorted, coalesced sequential runs and execute
        them with retry.  The disk tier is authoritative for every group
        an engine tracks, so the residue is always empty — a group the
        store cannot read escalates as :class:`FetchFailed` rather than
        passing silently to a tier that does not exist."""
        plan = self.scheduler.plan(gids)
        if plan and self._obs is not None and self._obs.enabled:
            st = self.scheduler.stats(plan)
            self._m_plan_requests.inc(st["requests"])
            self._m_plan_groups.inc(st["groups_read"])
            self._m_plan_wasted.inc(st["groups_wasted"])
        served: list[tuple[int, np.ndarray]] = []
        for run in plan:
            # each group as the extent read holds it, [G, 2, Hkv, d]
            blk = self.read_run_with_retry(row, run, layer=layer).block
            served.extend((int(gid), blk[gid - run.start]) for gid in run.ids)
        return served, []

    def admit(self, layer: int, row: int, gid: int, kv: np.ndarray, *,
              scale=None, disk_nbytes: int | None = None) -> bool:
        """Append one group at the row's watermark.  The disk layout is
        strictly sequential (groups append as the rolling buffer fills),
        so only ``gid == n_groups[layer, row]`` is accepted; anything else
        is declined rather than silently reordered."""
        if int(gid) != int(self.store.n_groups[layer, row]):
            return False
        kv = np.asarray(kv)
        self.store.append_group_row(layer, row, kv[:, 0], kv[:, -1])
        return True

    def invalidate(self, layer: int, row: int, gid: int) -> None:
        """Truncate the row's watermark to ``gid``: that group and every
        later one become unreachable (a sequential store cannot punch a
        hole mid-row — dropping the suffix is the coherent analogue, the
        same shape as prefix-chain quarantine)."""
        ng = int(self.store.n_groups[layer, row])
        if int(gid) < ng:
            self.store.n_groups[layer, row] = int(gid)
            if self.store.warm is not None:
                self.store.warm.invalidate_range(layer, row, int(gid))

    def free_row(self, row: int) -> None:
        self.store.free_row(row)

    def row_bytes(self, row: int) -> int:
        return int(self.store.n_groups[:, row].sum()) * self.store.group_nbytes
