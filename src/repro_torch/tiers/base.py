"""The ``KVTier`` protocol: one interface for every KV storage tier.

PRs 2, 5, and 8 accreted three special-cased storage layers — the disk
store, the host-RAM warm tier, and the content-addressed prefix cache —
each with its own ad-hoc surface, and ``KVCacheManager.fetch`` hand-inlined
the reuse→warm→disk branches.  KVDrive (PAPERS.md) argues the stack behind
a KV cache should be *one* coherent multi-tier interface; this module is
that interface, and the manager now walks an **ordered tier chain**
instead of branching per tier.

Every tier speaks the same five verbs over ``(layer, row, gid)`` group
keys (``gid`` = group index in the row's KV sequence):

* :meth:`~KVTier.lookup` — which of the asked-for groups are resident,
  side-effect-free (no stats, no LRU movement, no charging);
* :meth:`~KVTier.serve` — read one resident group (or ``None`` on miss),
  charging the tier's modeled cost through the shared
  :class:`~repro.core.offload.IOAccountant`;
* :meth:`~KVTier.admit` — insert/append one group;
* :meth:`~KVTier.invalidate` — drop one group (rewrite coherence);
* :meth:`~KVTier.free_row` — drop everything a row holds and zero its
  accounting (:meth:`~KVTier.row_bytes`).

Batch reads go through :meth:`~KVTier.serve_run`, which a tier may
override to coalesce (the disk tier plans sorted sequential runs); the
default serves group-by-group in request order.  ``serve_run`` returns the
*residue* — groups this tier could not serve — which the chain walker
hands to the next tier down, so miss resolution is literally::

    residue = misses
    for tier in chain:
        served, residue = tier.serve_run(layer, row, residue, dtype)

``tests/test_tiers_conformance.py`` runs one conformance suite against
every implementation (lookup-after-admit, rewrite-wins, free_row clears
accounting).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["KVTier"]


class KVTier:
    """Base class / protocol for one storage tier of the KV hierarchy.

    Group payloads are ``[G, 2, H_kv, d]`` arrays (K and V stacked on
    axis 1) — the exact shape the reuse buffer holds and the attention
    gather consumes, so groups move between tiers without reshaping.
    """

    #: short stable identifier ("warm", "disk", "prefix") used in stats,
    #: obs label values and error messages
    name: str = "tier"

    # -- reads ------------------------------------------------------------
    def lookup(self, layer: int, row: int,
               gids: Sequence[int]) -> list[int]:
        """The subset of ``gids`` resident in this tier, in request order.

        Observably side-effect-free: no stats, no LRU movement, no
        accountant charge — safe to poll for scheduling decisions.
        """
        raise NotImplementedError

    def serve(self, layer: int, row: int, gid: int,
              dtype) -> np.ndarray | None:
        """Read one group as ``[G, 2, H_kv, d]`` of ``dtype``; ``None`` on
        miss.  A hit charges this tier's modeled cost to the accountant
        (and may have tier-specific side effects, e.g. the warm tier's
        exclusive pop-on-hit)."""
        raise NotImplementedError

    def serve_run(self, layer: int, row: int, gids: Sequence[int],
                  dtype) -> tuple[list[tuple[int, np.ndarray]], list[int]]:
        """Serve a batch of groups: ``(served, residue)``.

        ``served`` is ``[(gid, kv), ...]`` in this tier's deterministic
        completion order; ``residue`` preserves request order and goes to
        the next tier down the chain.  The default serves group-by-group
        via :meth:`serve`; tiers with a planner (disk) override it to
        coalesce."""
        served: list[tuple[int, np.ndarray]] = []
        residue: list[int] = []
        for gid in gids:
            kv = self.serve(layer, row, int(gid), dtype)
            if kv is None:
                residue.append(int(gid))
            else:
                served.append((int(gid), kv))
        return served, residue

    # -- writes -----------------------------------------------------------
    def admit(self, layer: int, row: int, gid: int, kv: np.ndarray, *,
              scale=None, disk_nbytes: int | None = None) -> bool:
        """Insert one group; returns False when the tier declines (budget
        exhausted, out-of-order append, ...).  ``scale``/``disk_nbytes``
        are optional quantization/accounting metadata (see WarmTier)."""
        raise NotImplementedError

    def invalidate(self, layer: int, row: int, gid: int) -> None:
        """Drop one group so a later :meth:`lookup`/:meth:`serve` misses.
        The rewrite-coherence verb: whoever rewrites an extent invalidates
        the copies above it.  Idempotent on an absent group."""
        raise NotImplementedError

    def free_row(self, row: int) -> None:
        """Retire a row across **all** layers: every group it holds in
        this tier is dropped and :meth:`row_bytes` returns 0."""
        raise NotImplementedError

    # -- accounting -------------------------------------------------------
    def row_bytes(self, row: int) -> int:
        """Bytes this tier currently holds on behalf of ``row`` (the
        conformance suite's free_row check).  Tiers whose residency is
        shared rather than per-row (the prefix cache) count only the
        row-attributed portion (staged, unpublished payload)."""
        raise NotImplementedError
