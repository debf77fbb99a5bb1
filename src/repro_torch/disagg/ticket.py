"""The prefill ticket: the unit of work crossing the prefill/decode boundary.

The port of :mod:`repro.disagg.ticket`, with no difference but the package name.

Disaggregated serving splits a request's life in two: a **prefill engine**
computes the prompt's KV and publishes it as a hash-chain into the shared
:class:`~repro_torch.cache.PrefixCache`; a **decode session** later restores
that chain by reference and samples tokens.  The :class:`PrefillTicket`
is everything the boundary needs to carry:

* the request itself (prompt, sampling, stops, arrival, labels) — the
  decode side re-submits it verbatim, so the token stream stays
  bit-identical to a co-located run;
* the **chain head** block id returned by
  :meth:`~repro_torch.core.engine.KVSwapEngine.publish` — the content-addressed
  handle the decode side resolves (``PrefixCache.chain_metas``) and
  verifies without re-hashing the prompt;
* the **modeled ready time** — when prefill + publish completed on the
  prefill engine's clock; the decode submission inherits it as its
  arrival, which is what keeps the two pools' clocks composable;
* the **attempt counter** of the re-prefill ladder — a chain found
  quarantined or corrupt at handoff re-queues the ticket (bounded by the
  front end's ``max_prefill_attempts``) instead of ever admitting a
  decode row from bad KV.

Ticket states (one-way except the requeue edge)::

    QUEUED --prefill+publish--> READY --verify ok--> ADMITTED --> DONE
       ^                          |                     |
       '----- requeue (corrupt) --'                     '--> FAILED
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.serving.sampling import SamplingParams

__all__ = ["PrefillTicket", "QUEUED", "READY", "ADMITTED", "DONE", "FAILED"]

QUEUED = "queued"        # waiting for (or being) prefilled
READY = "ready"          # published; sitting in the handoff queue
ADMITTED = "admitted"    # submitted to a decode session
DONE = "done"            # decode completed; tokens available
FAILED = "failed"        # terminal: storage fault or retry budget exhausted


@dataclasses.dataclass
class PrefillTicket:
    """One request's crossing of the prefill/decode boundary."""

    rid: int                            # global id (the front end's)
    prompt: np.ndarray                  # [S] int64
    max_new: int
    stop_ids: tuple = ()
    sampling: SamplingParams | None = None
    sampler: Callable | None = dataclasses.field(default=None, repr=False)
    arrival: float = 0.0                # modeled submit time (requeues bump it)
    slo_class: str = ""
    tenant: str = ""
    submitted_at: float = 0.0           # the original arrival, never bumped

    state: str = QUEUED
    # deepest resident block id of the published chain (None: nothing
    # published — e.g. a prompt shorter than one block, or a failed
    # best-effort publish; the decode side then admits cold)
    chain_head: str | None = None
    ready_time: float | None = None     # prefill-engine clock at READY
    attempts: int = 0                   # prefill passes consumed (>=1 once READY)
    prefill_engine: str = ""            # which engine ran the last pass
    prefill_report: dict = dataclasses.field(default_factory=dict)
    decode_name: str = ""               # which decode session admitted it
    decode_rid: int | None = None       # local rid inside that session
    error: str | None = None            # set iff state == FAILED
