"""Bounded retry-with-backoff on the modeled clock (docs/robustness.md).

The repo's latency story is *modeled* (``DiskSpec`` seconds charged to an
:class:`~repro.core.offload.IOAccountant`), so retry backoff must be too:
nothing here ever sleeps.  Callers pass ``on_backoff`` to charge each
delay — the :class:`~repro.core.manager.KVCacheManager` charges
``IOAccountant.charge_stall`` so backoff lands in the same
``io_seconds`` every report and SLO computation already reads — and an
optional ``clock`` callable for deadline enforcement (tests drive a fake
clock; the engine runs attempt-bounded with no deadline).

Only :class:`~repro.faults.errors.TransientFault` is retried.  Persistent
faults (:class:`~repro.faults.errors.MediaError`) pass straight through
on the first attempt — retrying unreadable media just burns the latency
budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.faults.errors import RetriesExhausted, TransientFault

__all__ = ["RetryPolicy", "call_with_retries"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs of one bounded retry loop.

    ``max_attempts`` counts *total* attempts (1 = no retry).  Backoff is
    exponential — ``backoff_base_s * backoff_mult**(failure-1)``, capped
    at ``backoff_max_s`` — and fully deterministic (no jitter: the repo's
    bit-identity contracts extend to modeled time, and a deterministic
    sequence is what the fake-clock tests pin).  ``deadline_s`` bounds
    the whole loop on the caller's clock; ``None`` bounds by attempts
    only.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.002
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.05
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")

    def backoff(self, failure: int) -> float:
        """Modeled delay after the ``failure``-th failed attempt (1-based)."""
        return min(self.backoff_base_s * self.backoff_mult ** (failure - 1),
                   self.backoff_max_s)


def call_with_retries(fn: Callable, *, policy: RetryPolicy,
                      on_backoff: Optional[Callable[[float], None]] = None,
                      clock: Optional[Callable[[], float]] = None):
    """Run ``fn()`` with bounded retry on :class:`TransientFault`.

    ``on_backoff(delay_s)`` fires once per retried failure with the
    modeled delay — the caller charges it (and a fake-clock test advances
    its clock there).  ``clock()`` is consulted only when
    ``policy.deadline_s`` is set; crossing the deadline escalates even if
    attempts remain.  Escalation raises
    :class:`~repro.faults.errors.RetriesExhausted` with the last
    transient failure chained as ``__cause__``; non-transient exceptions
    (including :class:`~repro.faults.errors.PersistentFault`) propagate
    immediately.
    """
    t0 = clock() if (clock is not None and policy.deadline_s is not None) else 0.0
    failures = 0
    while True:
        try:
            return fn()
        except TransientFault as exc:
            failures += 1
            if failures >= policy.max_attempts:
                raise RetriesExhausted(
                    f"gave up after {failures} attempts: {exc}",
                    attempts=failures) from exc
            if policy.deadline_s is not None and clock is not None \
                    and clock() - t0 >= policy.deadline_s:
                raise RetriesExhausted(
                    f"deadline {policy.deadline_s}s exceeded after "
                    f"{failures} attempts: {exc}",
                    attempts=failures, deadline_s=policy.deadline_s) from exc
            if on_backoff is not None:
                on_backoff(policy.backoff(failures))
