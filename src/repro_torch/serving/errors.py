"""Typed front-door errors for the serving session.

A rejection is the session refusing work *before* admission — capacity
that could never fit, or load shedding while the degradation ladder is
engaged (docs/robustness.md).  It is structured (``reason`` +  keyword
context as attributes) so trace harnesses and clients branch on fields,
never on message text, and it must leave every running request
untouched: rejecting is an O(1) bookkeeping decision, not an engine
operation.
"""

from __future__ import annotations

__all__ = ["RequestRejected"]


class RequestRejected(ValueError):
    """The session refused to enqueue a request.

    ``ValueError`` ancestry keeps pre-existing ``except ValueError``
    front-door call sites working.  ``reason`` is a stable token:

    * ``"capacity"`` — prompt + max_new can never fit the engine's KV
      capacity (admitting it would crash decode mid-flight);
    * ``"overload"`` — the degradation ladder is shedding new work
      (sustained step-latency inflation, see ``DegradationPolicy``).

    The multi-replica front end (:mod:`repro.router`) raises the same
    type for router-tier shedding, before any replica session is touched:

    * ``"no_live_replicas"`` — every replica is draining or quiesced;
    * ``"router_overload"``  — all live replicas are at the front end's
      ``max_queue_depth`` admission bound.
    """

    def __init__(self, reason: str, message: str = "", **context):
        super().__init__(message or reason)
        self.reason = reason
        self.context = dict(context)
        for key, value in context.items():
            setattr(self, key, value)
