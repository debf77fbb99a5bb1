"""Disaggregated prefill/decode serving over the unified KVTier stack.

The port of :mod:`repro.disagg`.  The one difference from the reference:
:class:`~repro_torch.disagg.prefill.PrefillEngine` takes ``device=``
(``None`` = the CUDA card) for the engine it builds.

Dedicated **prefill engines** (:class:`~repro_torch.disagg.prefill.
PrefillEngine`) turn requests into published hash chains in a shared
:class:`~repro_torch.cache.PrefixCache`; **decode sessions** (plain
:class:`~repro_torch.serving.api.ServeSession`\\ s over the same cache) restore
those chains at admission and sample tokens.  The
:class:`~repro_torch.disagg.frontend.DisaggFrontEnd` connects the two pools
with a handoff queue of :class:`~repro_torch.disagg.ticket.PrefillTicket`\\ s,
steps both in modeled-clock lockstep, and stretches the fault ladder
across the boundary: a chain found corrupt at handoff is quarantined and
its ticket re-queued for a bounded re-prefill — a decode row is never
admitted from a quarantined chain.

Usage::

    cache = PrefixCache(dir, PrefixCacheConfig())
    prefills = [PrefillEngine(f"p{i}", model, params, cfg, cache=cache)
                for i in range(2)]
    decode = ServeSession(model, params, cfg, slots=4, prefix_cache=cache)
    front = DisaggFrontEnd(prefills, [decode], cache=cache)
    rid = front.submit({"prompt": ids, "max_tokens": 32})
    front.drain()
    tokens = front.result(rid)

See docs/architecture.md ("Disaggregated serving") for the ticket
lifecycle and the tier-chain walk, docs/tuning.md for the knobs, and
``benchmarks/disagg_serving.py`` for the TPOT-under-burst headline.
"""

from repro_torch.disagg.frontend import DisaggFrontEnd
from repro_torch.disagg.prefill import PrefillEngine
from repro_torch.disagg.ticket import (ADMITTED, DONE, FAILED, QUEUED, READY,
                                 PrefillTicket)

__all__ = ["ADMITTED", "DONE", "DisaggFrontEnd", "FAILED", "PrefillEngine",
           "PrefillTicket", "QUEUED", "READY"]
