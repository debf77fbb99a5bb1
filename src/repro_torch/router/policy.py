"""Pluggable routing policies: round-robin, least-loaded, prefix affinity.

The port of :mod:`repro.router.policy`, with no difference but the package name.

A policy sees the **admissible candidates** (live replicas under the
front end's queue bound, in pool order) plus the prompt and the raw
request dict, and returns one replica.  Policies are pure decisions over
O(1) replica signals — no engine calls, no I/O, no mutation of replica
state — so routing N candidates costs N metadata reads.

Determinism contract: given the same candidate list, prompt, and policy
state, ``choose`` returns the same replica.  All ties resolve to the
first candidate in pool order (``min``/``max`` over a stable list), so
fleet runs are reproducible under a fixed seed.

The headline :class:`PrefixAffinityRouter` scores KV locality the same
way the cache stores it: the prompt is hashed into the identical
content-addressed block-ID chain :class:`~repro_torch.cache.PrefixCache` uses
(via the side-effect-free :meth:`~repro_torch.cache.PrefixCache.peek`), so
"which replica holds this prompt's longest cached prefix" is answered
from manifest metadata alone — the LMCache insight that turns KV reuse
into a cross-instance asset.  Score::

    score(r) = peek(prompt) / len(prompt)          # affinity, 0..1
             - load_weight      * r.load           # occupancy / slots
             - overload_penalty * r.degradation_level

The load term spreads cold tenants across an initially-empty fleet
(everyone peeks 0, least-loaded wins); once a tenant's conversation
lands somewhere, affinity dominates and keeps its turns sticky.  The
overload penalty reuses the :class:`~repro_torch.serving.api.DegradationPolicy`
hysteresis signal: a replica whose storage stack is visibly stalling
(level >= 1) is scored down by whole affinity units, so warmth never
pins work to a drowning replica.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from repro_torch.router.pool import Replica

__all__ = ["RoutingPolicy", "RoundRobin", "LeastLoaded",
           "PrefixAffinityRouter"]


class RoutingPolicy:
    """Interface: pick one replica from the admissible candidates."""

    name = "policy"

    def choose(self, candidates: Sequence[Replica], prompt: np.ndarray,
               request: Mapping) -> Replica:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class RoundRobin(RoutingPolicy):
    """Cycle through candidates in pool order, ignoring all signals —
    the baseline the affinity benchmark measures against."""

    name = "round_robin"

    def __init__(self):
        self._n = 0

    def choose(self, candidates, prompt, request) -> Replica:
        rep = candidates[self._n % len(candidates)]
        self._n += 1
        return rep


class LeastLoaded(RoutingPolicy):
    """Minimize occupancy: fewest (waiting + running) per slot wins,
    ties to pool order."""

    name = "least_loaded"

    def choose(self, candidates, prompt, request) -> Replica:
        return min(candidates, key=lambda r: r.load)


class PrefixAffinityRouter(RoutingPolicy):
    """KV-locality routing: longest cached prefix wins, blended with
    load and the degradation overload penalty (module docstring has the
    scoring formula and the rationale for each term).

    ``load_weight`` is in affinity units per unit load: 0.5 means a
    replica must hold >= half the prompt cached to out-score an idle
    cold replica when it is itself fully occupied.  ``overload_penalty``
    is in affinity units per degradation rung; >= 1.0 guarantees even a
    fully-cached prompt routes away from a shedding replica.
    """

    name = "prefix_affinity"

    def __init__(self, load_weight: float = 0.5,
                 overload_penalty: float = 2.0):
        if load_weight < 0 or overload_penalty < 0:
            raise ValueError("load_weight and overload_penalty must be >= 0")
        self.load_weight = float(load_weight)
        self.overload_penalty = float(overload_penalty)

    def score(self, replica: Replica, prompt: np.ndarray) -> float:
        affinity = replica.peek_tokens(prompt) / max(len(prompt), 1)
        return (affinity
                - self.load_weight * replica.load
                - self.overload_penalty * replica.session.degradation_level)

    def choose(self, candidates, prompt, request) -> Replica:
        return max(candidates, key=lambda r: self.score(r, prompt))

    def __repr__(self) -> str:
        return (f"PrefixAffinityRouter(load_weight={self.load_weight}, "
                f"overload_penalty={self.overload_penalty})")
