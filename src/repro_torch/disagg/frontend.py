"""Disaggregated front end: prefill pool + decode pool, one clock discipline.

The port of :mod:`repro.disagg.frontend`, with no difference but the package name.

:class:`DisaggFrontEnd` mirrors the multi-replica
:class:`~repro_torch.router.frontend.FrontEnd` API (``submit`` / ``step`` /
``step_until`` / ``drain`` / ``stats`` / ``aggregate`` / ``replay``) but
splits every request across two pools connected by a **handoff queue**:

1. ``submit()`` parses the same OpenAI-style dict
   (:func:`~repro_torch.router.frontend.parse_request`), pre-checks decode KV
   capacity, sheds when the handoff queue is at ``max_handoff_depth``
   (``reason="handoff_overload"``), and enqueues a
   :class:`~repro_torch.disagg.ticket.PrefillTicket` on the least-loaded
   prefill engine.
2. The **lockstep loop** always steps the laggard unit — the prefill
   engine or decode session with the earliest next event on its modeled
   clock — so handoffs happen at contemporaneous times and neither pool
   races ahead of the other's clock.
3. After every step the **pump** moves READY tickets across the boundary:
   the published chain is resolved *by reference*
   (``PrefixCache.chain_metas(ticket.chain_head)``) and checksum-verified
   (``verify_chain``) **before** any decode session sees the request.  A
   broken or corrupt chain is quarantined and the ticket re-queued for
   re-prefill (arrival = its ready time, so the retry pays queueing
   honestly), bounded by ``max_prefill_attempts``; on exhaustion the
   ticket fails terminally.  A decode row is therefore *never* admitted
   from a quarantined chain.
4. Decode sessions are plain :class:`~repro_torch.serving.api.ServeSession`\\ s
   sharing the prefill pool's :class:`~repro_torch.cache.PrefixCache`: their
   admission restores the published chain (the warm-prefill path), so the
   decode clock pays restore I/O instead of prefill compute — which is
   the whole point of the split.

Bit-identity: the decode session recomputes admission logits from the
restored prefix exactly as a cold prefill would (the cache's restore
contract at ``kv_bits=16``), and a request's token stream depends only on
its own prompt + sampling — so disaggregated tokens equal co-located and
solo tokens per request.  ``benchmarks/disagg_serving.py`` asserts this.
"""

from __future__ import annotations

import collections
from typing import Mapping

import numpy as np

from repro_torch.disagg.prefill import PrefillEngine
from repro_torch.disagg.ticket import (ADMITTED, DONE, FAILED, QUEUED, READY,
                                 PrefillTicket)
from repro_torch.obs import NULL_OBS
from repro_torch.router.frontend import parse_request
from repro_torch.serving.api import ServeSession
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.metrics import aggregate_requests, request_record

__all__ = ["DisaggFrontEnd"]


class DisaggFrontEnd:
    """Schedule a prefill pool and a decode pool in modeled-clock lockstep.

    ``max_handoff_depth`` bounds the READY-ticket queue at admission time
    (router-tier shedding, pure bookkeeping); ``max_prefill_attempts``
    bounds the corrupt-chain re-prefill ladder per ticket.
    """

    def __init__(self, prefills: list[PrefillEngine],
                 decodes: list[ServeSession], *, cache,
                 max_handoff_depth: int | None = None,
                 max_prefill_attempts: int = 3, obs=None):
        if not prefills or not decodes:
            raise ValueError("need at least one prefill engine and one "
                             "decode session")
        if max_handoff_depth is not None and max_handoff_depth < 1:
            raise ValueError("max_handoff_depth must be >= 1 (or None)")
        if max_prefill_attempts < 1:
            raise ValueError("max_prefill_attempts must be >= 1")
        self.prefills = list(prefills)
        self.decodes = list(decodes)
        self._decode_names = [f"d{i}" for i in range(len(decodes))]
        self.cache = cache
        self.max_handoff_depth = max_handoff_depth
        self.max_prefill_attempts = max_prefill_attempts
        self.obs = obs if obs is not None else NULL_OBS
        self.handoff: collections.deque[PrefillTicket] = collections.deque()
        self.tickets: dict[int, PrefillTicket] = {}
        self.handoff_rejections = 0     # shed at submit (handoff_overload)
        self.requeues = 0               # corrupt-chain re-prefills
        self.ticket_failures = 0        # terminal ticket failures
        self.max_handoff_seen = 0       # high-water mark of READY tickets
        self._rid = 0

    # -- obs helpers ------------------------------------------------------
    def _count(self, name: str, help: str, delta: float = 1,
               **labels) -> None:
        if self.obs.enabled:
            self.obs.registry.counter(name, help, labels=labels).inc(delta)

    # -- admission --------------------------------------------------------
    def submit(self, request: Mapping) -> int:
        """Queue one request for prefill; returns its global id.

        Raises :class:`RequestRejected` with ``reason="capacity"`` when
        the prompt could never fit a decode engine, or
        ``reason="handoff_overload"`` when the handoff queue is at its
        bound — both before any engine is touched."""
        prompt, max_new, kw = parse_request(request)
        cap = min(d.engine.cap_tokens for d in self.decodes)
        if len(prompt) + max_new > cap:
            self._count("kvswap_disagg_rejections_total",
                        "disagg front-end shed submissions",
                        reason="capacity")
            raise RequestRejected(
                "capacity",
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"decode pool's KV capacity ({cap} tokens)",
                prompt_tokens=len(prompt), max_new=max_new, cap_tokens=cap)
        if self.max_handoff_depth is not None \
                and len(self.handoff) >= self.max_handoff_depth:
            self.handoff_rejections += 1
            self._count("kvswap_disagg_rejections_total",
                        "disagg front-end shed submissions",
                        reason="handoff_overload")
            raise RequestRejected(
                "handoff_overload",
                f"handoff queue is at max_handoff_depth="
                f"{self.max_handoff_depth}; decode pool is behind",
                max_handoff_depth=self.max_handoff_depth,
                queued=len(self.handoff))
        rid = self._rid
        self._rid += 1
        arrival = kw["arrival"] if kw["arrival"] is not None else 0.0
        ticket = PrefillTicket(
            rid=rid, prompt=prompt, max_new=max_new,
            stop_ids=kw["stop_ids"], sampling=kw["sampling"],
            arrival=arrival, submitted_at=arrival,
            slo_class=kw["slo_class"], tenant=kw["tenant"])
        self.tickets[rid] = ticket
        self._assign(ticket)
        self._count("kvswap_disagg_tickets_total",
                    "tickets submitted to the prefill pool")
        return rid

    def _assign(self, ticket: PrefillTicket) -> None:
        """Least-queued prefill engine, ties to pool order."""
        eng = min(self.prefills, key=lambda e: (len(e.queue), e.name))
        eng.enqueue(ticket)

    # -- the handoff pump --------------------------------------------------
    def _verify(self, ticket: PrefillTicket) -> bool:
        """Chain integrity at the boundary.  True = safe to hand to
        decode.  A broken handle (evicted/quarantined ancestor) or a
        checksum mismatch (which quarantines, exactly like a restore
        would) is False — the decode pool never sees the ticket."""
        if ticket.chain_head is None:
            return True     # nothing published: decode admits cold
        metas = self.cache.chain_metas(ticket.chain_head)
        if metas is None:
            return False
        return self.cache.verify_chain(metas)

    def _requeue(self, ticket: PrefillTicket) -> None:
        """Corrupt chain at handoff: bounded re-prefill, or terminal."""
        if ticket.attempts >= self.max_prefill_attempts:
            ticket.state = FAILED
            ticket.error = (f"chain {ticket.chain_head} corrupt at handoff "
                            f"after {ticket.attempts} prefill attempt(s)")
            self.ticket_failures += 1
            self._count("kvswap_disagg_ticket_failures_total",
                        "tickets failed terminally", reason="corrupt_chain")
            if self.obs.enabled:
                self.obs.tracer.add(
                    f"r{ticket.rid} failed", "handoff", cat="disagg",
                    model_t0=ticket.ready_time, instant=True,
                    args={"rid": ticket.rid, "error": ticket.error})
            return
        self.requeues += 1
        self._count("kvswap_disagg_requeues_total",
                    "tickets re-queued for re-prefill (corrupt chain)")
        if self.obs.enabled:
            self.obs.tracer.add(
                f"r{ticket.rid} requeue", "handoff", cat="disagg",
                model_t0=ticket.ready_time, instant=True,
                args={"rid": ticket.rid, "attempt": ticket.attempts,
                      "chain_head": ticket.chain_head or ""})
        # the retry arrives when the corruption was discovered — queueing
        # time is honest, and the re-prefill's restore path reuses any
        # ancestors that survived the quarantine
        ticket.arrival = float(ticket.ready_time)
        ticket.chain_head = None
        ticket.ready_time = None
        self._assign(ticket)

    def _pump(self) -> None:
        """Drain the handoff queue into decode sessions (FIFO by ready
        time).  Each ticket is verified first; survivors are submitted to
        the least-loaded decode session with ``arrival=ready_time`` so the
        decode clock honors the prefill pool's completion times."""
        self.max_handoff_seen = max(self.max_handoff_seen, len(self.handoff))
        while self.handoff:
            ticket = self.handoff.popleft()
            if ticket.state is not READY:
                continue
            if not self._verify(ticket):
                self._requeue(ticket)
                continue
            di = min(range(len(self.decodes)),
                     key=lambda i: (self.decodes[i].queue_depth
                                    + self.decodes[i].active_rows, i))
            ds = self.decodes[di]
            try:
                local = ds.submit(
                    ticket.prompt, ticket.max_new,
                    stop_ids=ticket.stop_ids, sampling=ticket.sampling,
                    sampler=ticket.sampler, arrival=ticket.ready_time,
                    slo_class=ticket.slo_class, tenant=ticket.tenant)
            except RequestRejected as exc:
                # the decode tier refused (overload shedding mid-incident);
                # terminal — retrying would deadlock drain on a session
                # that keeps saying no
                ticket.state = FAILED
                ticket.error = f"decode rejected: {exc.reason}"
                self.ticket_failures += 1
                self._count("kvswap_disagg_ticket_failures_total",
                            "tickets failed terminally",
                            reason="decode_rejected")
                continue
            ticket.state = ADMITTED
            ticket.decode_name = self._decode_names[di]
            ticket.decode_rid = local
            if self.obs.enabled:
                self.obs.tracer.add(
                    f"r{ticket.rid} handoff", "handoff", cat="disagg",
                    model_t0=ticket.ready_time, instant=True,
                    args={"rid": ticket.rid, "decode": ticket.decode_name,
                          "chain_head": ticket.chain_head or "",
                          "cached_tokens":
                              ticket.prefill_report.get("cached_tokens", 0)})

    # -- the lockstep scheduler loop --------------------------------------
    def _decode_next_time(self, ds: ServeSession) -> float:
        """A decode session's next event time: its clock while rows run,
        else the earliest waiting arrival (the session's own idle-jump),
        else ``inf``."""
        if ds.active_rows:
            return ds.now
        if ds.queue_depth:
            return max(ds.now, min(r.arrival for r in ds._waiting))
        return float("inf")

    def _units(self) -> list[tuple[float, int, str, object]]:
        """Steppable units ordered (next_time, pool order) — prefill
        engines before decode sessions on exact ties, so a handoff
        produced at time T is pumped before the decode pool steps past
        T."""
        units: list[tuple[float, int, str, object]] = []
        for i, pe in enumerate(self.prefills):
            if pe.has_work:
                units.append((pe.next_time, i, "prefill", pe))
        off = len(self.prefills)
        for i, ds in enumerate(self.decodes):
            if ds.has_work:
                units.append((self._decode_next_time(ds), off + i,
                              "decode", ds))
        units.sort(key=lambda u: (u[0], u[1]))
        return units

    def step(self) -> list[dict]:
        """One lockstep iteration: step the laggard unit, then pump the
        handoff queue.  Returns that unit's events, each stamped with a
        ``"phase"`` key; an idle system returns ``[]``."""
        units = self._units()
        if not units:
            return []
        _, _, phase, unit = units[0]
        events: list[dict] = []
        if phase == "prefill":
            ticket = unit.step()
            if ticket is not None:
                if ticket.state is READY:
                    self.handoff.append(ticket)
                    events.append({"type": "prefill_done", "rid": ticket.rid,
                                   "engine": unit.name, "t": ticket.ready_time,
                                   "attempt": ticket.attempts,
                                   "chain_head": ticket.chain_head})
                else:   # admission storage fault: terminal
                    self.ticket_failures += 1
                    self._count("kvswap_disagg_ticket_failures_total",
                                "tickets failed terminally",
                                reason="prefill_fault")
                    events.append({"type": "prefill_fail", "rid": ticket.rid,
                                   "engine": unit.name, "t": unit.now,
                                   "error": ticket.error})
        else:
            for ev in unit.step():
                ev["phase"] = "decode"
                events.append(ev)
        self._pump()
        return events

    def step_until(self, t: float) -> list[dict]:
        """Advance every unit whose next event is before ``t`` (the replay
        loop's synchronizer — arrivals are routed against contemporaneous
        queue-depth signals)."""
        events: list[dict] = []
        while True:
            units = [u for u in self._units() if u[0] < t]
            if not units:
                return events
            events.extend(self.step())

    @property
    def has_work(self) -> bool:
        return (any(pe.has_work for pe in self.prefills)
                or bool(self.handoff)
                or any(ds.has_work for ds in self.decodes))

    def drain(self) -> dict[int, np.ndarray]:
        """Run both pools to completion; persists the shared cache's
        manifest once, then returns completed tokens by global id."""
        while self.has_work:
            if not self.step() and self.handoff:
                self._pump()    # only READY tickets left: flush them
        self.cache.save()
        return self.results()

    # -- results ----------------------------------------------------------
    def _completed(self, rid: int):
        ticket = self.tickets[rid]
        if ticket.decode_rid is None:
            return None
        ds = self.decodes[self._decode_names.index(ticket.decode_name)]
        req = ds.completed.get(ticket.decode_rid)
        if req is not None:
            ticket.state = DONE
        return req

    def results(self) -> dict[int, np.ndarray]:
        out = {}
        for rid in self.tickets:
            req = self._completed(rid)
            if req is not None:
                out[rid] = req.output
        return out

    def result(self, rid: int) -> np.ndarray:
        req = self._completed(rid)
        if req is None:
            raise KeyError(f"request {rid} has not completed")
        return req.output

    # -- stats ------------------------------------------------------------
    def stats(self) -> dict:
        """Two-pool view: per-unit snapshots plus cross-pool totals.
        ``makespan_s`` is the max clock across both pools; rates are
        recomputed from summed numerators/denominators."""
        prefill = [pe.stats() for pe in self.prefills]
        decode = {name: ds.stats() for name, ds
                  in zip(self._decode_names, self.decodes)}
        sessions = list(decode.values())

        def total(key):
            return sum(s[key] for s in sessions)

        makespan = max([p["now"] for p in prefill]
                       + [ds.now for ds in self.decodes] + [0.0])
        tokens = total("completed_tokens")
        prompt_tokens = total("prompt_tokens")
        cached = total("cached_prompt_tokens")
        return {
            "prefill_engines": prefill,
            "decode_sessions": decode,
            "n_prefill": len(self.prefills),
            "n_decode": len(self.decodes),
            "completed_requests": total("completed_requests"),
            "completed_tokens": tokens,
            "failed_requests": total("failed_requests"),
            "ticket_failures": self.ticket_failures,
            "handoff_rejections": self.handoff_rejections,
            "requeues": self.requeues,
            "max_handoff_depth_seen": self.max_handoff_seen,
            "handoff_pending": len(self.handoff),
            "prefill_published_blocks":
                sum(p["published_blocks"] for p in prefill),
            "makespan_s": makespan,
            "goodput_tokens_per_s": tokens / makespan if makespan else 0.0,
            "prompt_tokens": prompt_tokens,
            "cached_prompt_tokens": cached,
            "prefix_hit_rate": (cached / prompt_tokens
                                if prompt_tokens else 0.0),
        }

    def aggregate(self, slo_classes: Mapping) -> dict:
        """Per-request SLO aggregation across the decode pool, re-stamped
        with global rids.  End-to-end latency is corrected back to the
        *original* arrival (the decode request's arrival is the ticket's
        ready time, so prefill + handoff time would otherwise vanish);
        TTFT/TPOT stay decode-side by construction."""
        records = []
        for rid in sorted(self.tickets):
            ticket = self.tickets[rid]
            req = self._completed(rid)
            if req is None:
                continue
            rec = request_record(req)
            rec["rid"] = rid
            rec["prefill_engine"] = ticket.prefill_engine
            rec["decode"] = ticket.decode_name
            rec["prefill_attempts"] = ticket.attempts
            rec["e2e_seconds"] += float(ticket.ready_time) \
                - ticket.submitted_at
            records.append(rec)
        makespan = max([pe.now for pe in self.prefills]
                       + [ds.now for ds in self.decodes] + [0.0])
        agg = aggregate_requests(records, slo_classes, makespan_s=makespan)
        return {**agg, "per_request": records}

    # -- trace replay ------------------------------------------------------
    def replay(self, trace) -> dict:
        """Drive a :class:`~repro_torch.serving.trace.Trace` through the split
        stack as-it-arrives; shed submissions are part of the measurement.
        Returns the SLO aggregation plus :meth:`stats` under ``"fleet"``.
        """
        for r in trace.requests:
            self.step_until(r.arrival)
            try:
                self.submit({"prompt": r.materialize(trace.vocab_size),
                             "max_new": r.max_new, "arrival": r.arrival,
                             "slo_class": r.slo_class, "tenant": r.tenant})
            except RequestRejected:
                pass
        self.drain()
        agg = self.aggregate(trace.slo_classes)
        return {**agg, "fleet": self.stats()}

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for pe in self.prefills:
            pe.close()
        for ds in self.decodes:
            ds.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
