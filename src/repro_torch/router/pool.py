"""Replica registry and lifecycle for the multi-replica front end.

The port of :mod:`repro.router.pool`, with no difference but the package name.

A **replica** is one independent serving stack: its own
:class:`~repro_torch.serving.api.ServeSession` (engine, slots, modeled clock)
and — when attached — its own :class:`~repro_torch.cache.PrefixCache`
directory.  Replicas share nothing at runtime; the only cross-replica
coupling is the router's scheduler loop keeping their modeled clocks in
lockstep (:meth:`repro_torch.router.frontend.FrontEnd.step` always steps the
laggard).

Lifecycle is a one-way ladder::

    LIVE --drain()--> DRAINING --quiesce()--> QUIESCED
     |                   |                       |
     accepts new work    finishes queued work    session closed,
     + steppable         + steppable, no new     final stats frozen
                           routing

``drain()`` is the graceful half: the replica stops receiving routed
work but keeps stepping until its queue and rows empty.  ``quiesce()``
is the terminal half: it requires the drain to have finished (no
stranded requests, by construction — quiescing a replica that still has
work raises), snapshots ``session.stats()`` into ``final_stats`` so the
fleet view stays complete, and closes the session (publishing the
prefix-cache manifest like any session close).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

LIVE, DRAINING, QUIESCED = "live", "draining", "quiesced"

__all__ = ["LIVE", "DRAINING", "QUIESCED", "Replica", "ReplicaPool"]


class Replica:
    """One named serving replica plus the router's per-replica bookkeeping.

    The routing signals are deliberately O(1) reads off the session
    (``queue_depth``/``active_rows``/``degradation_level`` properties) or
    metadata-only cache walks (:meth:`peek_tokens`) — scoring N replicas
    per submission must never touch an engine or a disk.
    """

    def __init__(self, name: str, session):
        if getattr(getattr(session, "engine", None), "kv_planes", 2) == 1:
            raise ValueError("the router routes by the replicas' prefix caches, which "
                             "latent attention (MLA) cannot use")
        self.name = str(name)
        self.session = session
        self.state = LIVE
        self.routed = 0                 # requests this replica accepted
        self.shed = 0                   # replica-tier rejections (typed)
        self.final_stats: dict | None = None   # frozen at quiesce

    @property
    def cache(self):
        return self.session.prefix_cache

    def peek_tokens(self, prompt: np.ndarray) -> int:
        """Longest cached prefix of ``prompt`` on this replica, in tokens
        — the affinity signal.  Side-effect-free (``PrefixCache.peek``);
        a replica without a cache peeks 0 (affinity cannot distinguish
        cacheless replicas, load does)."""
        cache = self.session.prefix_cache
        return cache.peek(prompt) if cache is not None else 0

    @property
    def load(self) -> float:
        """Occupancy in units of the replica's own capacity: (waiting +
        running) / slots.  Dimensionless so fleets may mix slot counts."""
        s = self.session
        return (s.queue_depth + s.active_rows) / s.n_slots

    @property
    def now(self) -> float:
        """The replica's modeled clock; frozen at its quiesce time once
        the session is closed."""
        if self.final_stats is not None:
            return self.final_stats["modeled_seconds"]
        return self.session.now

    @property
    def accepting(self) -> bool:
        return self.state == LIVE

    @property
    def steppable(self) -> bool:
        """True while the router's lockstep loop should still step this
        replica: not yet quiesced and a scheduler iteration would make
        progress."""
        return self.state != QUIESCED and self.session.has_work

    def snapshot(self) -> dict:
        """Per-replica state for the fleet stats view.  A quiesced
        replica reports its frozen ``final_stats``; live/draining
        replicas report the session's current cumulative stats."""
        base = {
            "state": self.state,
            "routed": self.routed,
            "shed": self.shed,
        }
        if self.final_stats is not None:
            return {**base, "now": self.final_stats["modeled_seconds"],
                    "queue_depth": 0, "active_rows": 0,
                    "session": self.final_stats}
        s = self.session
        return {**base, "now": s.now, "queue_depth": s.queue_depth,
                "active_rows": s.active_rows, "session": s.stats()}


class ReplicaPool:
    """Stable-ordered registry of replicas.

    Registration order is the router's global tie-break: every policy
    resolves score ties to the first replica in pool order, which is what
    makes replica choice deterministic under a fixed seed (asserted by
    ``tests/test_router.py``).
    """

    def __init__(self):
        self._replicas: dict[str, Replica] = {}

    def add(self, name: str, session) -> Replica:
        if name in self._replicas:
            raise ValueError(f"duplicate replica name: {name!r}")
        rep = Replica(name, session)
        self._replicas[name] = rep
        return rep

    def __len__(self) -> int:
        return len(self._replicas)

    def __iter__(self) -> Iterator[Replica]:
        return iter(self._replicas.values())

    def __getitem__(self, name: str) -> Replica:
        return self._replicas[name]

    def __contains__(self, name: str) -> bool:
        return name in self._replicas

    def names(self) -> list[str]:
        return list(self._replicas)

    def live(self) -> list[Replica]:
        """Replicas accepting new routed work, in pool order."""
        return [r for r in self if r.accepting]

    def steppable(self) -> list[Replica]:
        """Replicas the lockstep loop should still advance, in pool
        order (live *and* draining replicas with outstanding work)."""
        return [r for r in self if r.steppable]

    # -- lifecycle --------------------------------------------------------
    def drain(self, name: str) -> None:
        """Stop routing to ``name``; its queued/running work finishes via
        the normal lockstep loop.  Idempotent on an already-draining
        replica; a quiesced replica cannot re-enter the ladder."""
        rep = self[name]
        if rep.state == QUIESCED:
            raise ValueError(f"replica {name!r} is already quiesced")
        rep.state = DRAINING

    def quiesce(self, name: str) -> dict:
        """Terminal lifecycle step: freeze stats and close the session.

        Requires the replica to be draining with no outstanding work —
        quiescing is only legal once the drain actually finished, which
        is the structural guarantee that no request is ever stranded on
        a closed session.  Returns the frozen stats snapshot."""
        rep = self[name]
        if rep.state != DRAINING:
            raise ValueError(
                f"replica {name!r} must be draining to quiesce "
                f"(state={rep.state!r})")
        if rep.session.has_work:
            raise ValueError(
                f"replica {name!r} still has work "
                f"(queue={rep.session.queue_depth}, "
                f"rows={rep.session.active_rows}); step the front end "
                f"until it drains")
        rep.final_stats = rep.session.stats()
        rep.session.close()
        rep.state = QUIESCED
        return rep.final_stats

    def close(self) -> None:
        """Close every not-yet-quiesced session (fleet teardown)."""
        for rep in self:
            if rep.state != QUIESCED:
                rep.session.close()
