"""Dedicated prefill engines for disaggregated serving.

The port of :mod:`repro.disagg.prefill`; it differs only in ``device=``
(``None`` = the CUDA card), passed to the engine it builds.

A :class:`PrefillEngine` owns one single-row
:class:`~repro_torch.core.engine.KVSwapEngine` and does nothing but turn queued
:class:`~repro_torch.disagg.ticket.PrefillTicket`\\ s into published hash
chains: admit the prompt (the engine's normal chunked prefill — itself
warm-restoring any prefix already cached), ``publish()`` the resulting KV
into the **shared** :class:`~repro_torch.cache.PrefixCache`, record the chain
head on the ticket, and retire the row.  The engine never decodes — its
rolling buffer, reuse slots and disk extents are recycled per ticket.

Time is modeled on the engine's own clock: a ticket's prefill charges the
admission's ``modeled_seconds`` (restore + compute + spill) plus the
publish pass's accountant-tracked read/write seconds, and the completion
time becomes the ticket's ``ready_time`` — the arrival the decode side
inherits.  Prefill pools therefore overlap with decode *by construction*:
their clocks only meet at the handoff.

Fault ladder (docs/robustness.md, stretched across the boundary):

* transient read faults inside prefill retry through the engine's normal
  per-run retry budget;
* a :class:`~repro_torch.faults.errors.StorageFault` that escapes admission
  fails the ticket terminally (admission rolled the row back — same
  atomicity as a co-located session's admission);
* a failed **publish** is best-effort: the ticket still hands off (with
  whatever chain prefix is resident, possibly none) — publishing is
  cache warming, the decode side re-prefills the residue;
* corruption *after* publish is the front end's job: handoff-time chain
  verification re-queues the ticket here for a bounded re-prefill.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.disagg.ticket import FAILED, QUEUED, READY, PrefillTicket
from repro_torch.faults.errors import StorageFault

__all__ = ["PrefillEngine"]


class PrefillEngine:
    """One prefill pool member: a queue of tickets and a modeled clock."""

    def __init__(self, name: str, model, params, engine_cfg: EngineConfig, *,
                 cache, calib_k: np.ndarray | None = None, adapter=None,
                 obs=None, faults=None, device=None):
        kinds = getattr(model, "layer_kinds", ("kv",) * model.n_layers)
        if any(k != "kv" for k in kinds):
            raise ValueError("PrefillEngine requires attention-only models")
        if getattr(model, "kv_planes", 2) == 1:
            raise ValueError("PrefillEngine hands prompts over through the prefix cache, "
                             "which latent attention (MLA) cannot use")
        self.name = name
        self.engine = KVSwapEngine(model, params, engine_cfg, batch=1,
                                   calib_k=calib_k, adapter=adapter, obs=obs,
                                   faults=faults, device=device)
        self.obs = self.engine.obs
        self.cache = cache
        self.now = 0.0                  # modeled seconds, this pool member
        self.queue: list[PrefillTicket] = []
        self.tickets_done = 0
        self.tickets_failed = 0
        self.published_blocks = 0
        self.publish_failures = 0       # best-effort publishes that errored

    # -- the scheduler's signals ------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    @property
    def next_time(self) -> float:
        """When this engine's next ticket could start: its clock, or the
        earliest queued arrival if the engine is idle-waiting.  ``inf``
        with an empty queue — the lockstep scheduler skips it."""
        if not self.queue:
            return float("inf")
        return max(self.now, min(t.arrival for t in self.queue))

    def enqueue(self, ticket: PrefillTicket) -> None:
        ticket.state = QUEUED
        self.queue.append(ticket)

    # -- one prefill pass --------------------------------------------------
    def step(self) -> PrefillTicket | None:
        """Run the earliest due ticket through prefill + publish.

        Returns the ticket — state ``READY`` (in which case ``chain_head``
        / ``ready_time`` / ``prefill_report`` are filled) or ``FAILED``
        (admission storage fault) — or ``None`` when the queue is empty.
        """
        if not self.queue:
            return None
        self.queue.sort(key=lambda t: (t.arrival, t.rid))
        ticket = self.queue.pop(0)
        self.now = max(self.now, ticket.arrival)
        t0 = self.now
        ticket.attempts += 1
        ticket.prefill_engine = self.name
        eng = self.engine
        try:
            # chunked prefill; restores any already-cached prefix of the
            # prompt (re-prefills after a quarantine re-use the surviving
            # ancestors and only recompute the dropped suffix)
            eng.admit_row(0, ticket.prompt, self.cache)
        except StorageFault as exc:
            ticket.state = FAILED
            ticket.error = f"{type(exc).__name__}: {exc}"
            self.tickets_failed += 1
            return ticket
        rep = dict(eng.prefill_report)
        self.now += rep["modeled_seconds"]
        try:
            # the publish pass re-reads the row's extents and writes slab
            # blocks; both legs are modeled I/O this clock must absorb —
            # the decode pool never pays for them
            with eng.accountant.track() as tr:
                res = eng.publish(self.cache, tokens={0: ticket.prompt},
                                  rows=[0], save=False)
            self.now += tr.read_seconds + tr.write_seconds
            ticket.chain_head = res.heads.get(0)
            self.published_blocks += int(res)
        except StorageFault:
            self.publish_failures += 1
            ticket.chain_head = None
        finally:
            eng.retire_row(0)
        ticket.state = READY
        ticket.ready_time = self.now
        ticket.prefill_report = rep
        self.tickets_done += 1
        if self.obs.enabled:
            self.obs.tracer.add(
                f"prefill r{ticket.rid}", f"prefill:{self.name}",
                cat="disagg", model_t0=t0, model_dur=self.now - t0,
                args={"rid": ticket.rid, "attempt": ticket.attempts,
                      "prompt_tokens": rep["prompt_tokens"],
                      "cached_tokens": rep["cached_tokens"],
                      "chain_head": ticket.chain_head or ""})
        return ticket

    def stats(self) -> dict:
        return {
            "name": self.name,
            "now": self.now,
            "queued": len(self.queue),
            "tickets_done": self.tickets_done,
            "tickets_failed": self.tickets_failed,
            "published_blocks": self.published_blocks,
            "publish_failures": self.publish_failures,
        }

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
