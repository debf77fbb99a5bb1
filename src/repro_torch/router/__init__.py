"""Multi-replica front end with KV-affinity routing.

The port of :mod:`repro.router` (numpy only, over duck-typed sessions): a
replica is a :class:`repro_torch.serving.api.ServeSession` with its own
:class:`repro_torch.cache.PrefixCache`.  The code is the reference's.

N independent serving replicas (each its own
:class:`~repro_torch.serving.api.ServeSession` + :class:`~repro_torch.cache.
PrefixCache` directory) behind one request API:

* :class:`~repro_torch.router.pool.ReplicaPool` — registry + drain/quiesce
  lifecycle, per-replica load and affinity signals;
* :class:`~repro_torch.router.policy.RoutingPolicy` — pluggable policies:
  :class:`~repro_torch.router.policy.RoundRobin`,
  :class:`~repro_torch.router.policy.LeastLoaded`, and the headline
  :class:`~repro_torch.router.policy.PrefixAffinityRouter` that scores
  replicas by longest cached prefix via the side-effect-free
  ``PrefixCache.peek()`` (the content-addressed block-ID chain makes KV
  locality readable from metadata alone);
* :class:`~repro_torch.router.frontend.FrontEnd` — admission with typed
  router-tier shedding, laggard-first lockstep stepping of the replica
  clocks, global request ids, fleet stats/SLO aggregation.

Usage::

    pool = ReplicaPool()
    for i in range(3):
        pool.add(f"r{i}", ServeSession(..., prefix_cache=PrefixCache(...),
                                       obs=Observability(
                                           labels={"replica": f"r{i}"})))
    front = FrontEnd(pool, PrefixAffinityRouter(), max_queue_depth=8)
    rid = front.submit({"prompt": ids, "max_tokens": 32, "tenant": "t0"})
    front.drain()
    tokens = front.result(rid)

See docs/architecture.md ("Multi-replica routing") for the scoring
formula and the lockstep-clock rationale, docs/tuning.md for the knobs.
"""

from repro_torch.router.frontend import FrontEnd, parse_request
from repro_torch.router.policy import (LeastLoaded, PrefixAffinityRouter,
                                 RoundRobin, RoutingPolicy)
from repro_torch.router.pool import (DRAINING, LIVE, QUIESCED, Replica,
                               ReplicaPool)

__all__ = ["FrontEnd", "LeastLoaded", "PrefixAffinityRouter", "RoundRobin",
           "RoutingPolicy", "Replica", "ReplicaPool", "LIVE", "DRAINING",
           "QUIESCED", "parse_request"]
