"""Typed fault taxonomy for the storage stack (docs/robustness.md).

Every failure the tier stack can surface is a :class:`StorageFault`
subclass, split along the one axis recovery cares about:

* :class:`TransientFault` — retrying the *same* operation can succeed
  (flaky bus, short read).  Handled by bounded retry-with-backoff in
  :mod:`repro.faults.retry`; never escapes the
  :class:`~repro.core.manager.KVCacheManager` unless the retry budget is
  exhausted.
* :class:`PersistentFault` — retrying cannot help (unreadable media,
  exhausted retries).  Escalates as :class:`FetchFailed` with enough
  context (layer, row, group run) for the serving layer to fail exactly
  one request and recover the rest.

Integrity violations (:class:`CorruptBlockError`,
:class:`ManifestCorrupt`) and injected process deaths
(:class:`InjectedCrash`) are faults too, but of *stored state* rather
than of an I/O operation, so they hang directly off
:class:`StorageFault`.

The base class stores keyword context both as attributes (``exc.layer``)
and in ``exc.context`` (a plain dict for logging), so handlers never
parse messages.
"""

from __future__ import annotations

__all__ = [
    "StorageFault",
    "TransientFault",
    "TransientReadError",
    "TornReadError",
    "PersistentFault",
    "MediaError",
    "RetriesExhausted",
    "FetchFailed",
    "CorruptBlockError",
    "ManifestCorrupt",
    "InjectedCrash",
]


class StorageFault(RuntimeError):
    """Base of every typed storage-stack fault.

    ``RuntimeError`` ancestry keeps pre-existing ``except RuntimeError``
    call sites working; new code catches :class:`StorageFault` (or a
    subclass) and never a bare ``Exception``.
    """

    def __init__(self, message: str = "", **context):
        super().__init__(message or type(self).__name__)
        self.context = dict(context)
        for key, value in context.items():
            setattr(self, key, value)


class TransientFault(StorageFault):
    """A fault where retrying the same operation can succeed."""


class TransientReadError(TransientFault):
    """The device errored a read outright (flaky bus / controller retry)."""


class TornReadError(TransientFault):
    """The device returned fewer bytes than requested (short read)."""


class PersistentFault(StorageFault):
    """A fault retrying cannot fix."""


class MediaError(PersistentFault):
    """The extent is unreadable at the media level (grown bad block)."""


class RetriesExhausted(PersistentFault):
    """A transient fault survived the whole retry budget.

    Carries ``attempts`` and (when a deadline was set) ``deadline_s``;
    the final transient failure is chained as ``__cause__``.
    """


class FetchFailed(StorageFault):
    """A KV group run is unrecoverable after retries.

    Raised by :class:`~repro.core.manager.KVCacheManager` with
    ``layer``/``row``/``start``/``count`` context so
    :class:`~repro.serving.api.ServeSession` can fail the one affected
    request and replay the rest (docs/robustness.md, rung 2).
    """


class CorruptBlockError(StorageFault):
    """A prefix-cache block failed its extent checksum.

    The block (and every resident descendant) is already quarantined when
    this is raised; callers re-match the now-shorter chain and fall back,
    block by block, toward a cold prefill.  ``verified_blocks`` is how
    many chain blocks passed verification before the mismatch.
    """


class ManifestCorrupt(StorageFault):
    """The prefix-cache manifest on disk is truncated or garbage."""


class InjectedCrash(StorageFault):
    """A :class:`~repro.faults.plan.FaultPlan` crash point fired.

    Simulates dying mid-operation (e.g. a torn manifest write): the
    injection site leaves on-disk state exactly as a real crash would,
    then raises this instead of ``os._exit`` so tests and benchmarks can
    observe the recovery path in-process.
    """
