"""Multi-replica front end: admission, lockstep stepping, fleet stats.

The port of :mod:`repro.router.frontend`, with no difference but the package name.

:class:`FrontEnd` is the single entry point a client (or the trace
harness) talks to.  It owns:

* **Admission** — :meth:`submit` takes an OpenAI-style request dict,
  sheds at the router tier with the same typed
  :class:`~repro_torch.serving.errors.RequestRejected` the sessions use
  (``reason="no_live_replicas"`` / ``"router_overload"``), asks the
  :class:`~repro_torch.router.policy.RoutingPolicy` for a replica, and
  forwards to that replica's ``ServeSession.submit``.  Router-tier
  shedding is pure bookkeeping — no session is touched.
* **The lockstep clock** — each replica session runs its own modeled
  clock; :meth:`step` always advances the *laggard* (minimum
  ``session.now``, ties to pool order), so the fleet's clocks stay
  within one scheduler iteration of each other and load signals read
  during routing are contemporaneous.  :meth:`step_until` advances
  laggards up to a target time (how :meth:`replay` keeps routing
  decisions synchronized with trace arrivals); :meth:`drain` runs the
  fleet to completion.
* **Fleet stats** — per-replica snapshots plus cross-replica totals
  (:meth:`stats`) and the shared per-request SLO aggregation
  (:meth:`aggregate`), with per-replica labeled counters on the front
  end's own obs registry.

Request ids returned by :meth:`submit` are **global**: the front end
keeps a ``rid -> (replica, local rid)`` table, so callers never see
which replica served them (``result``/``aggregate`` resolve through the
table).

Determinism: policies are deterministic, sessions are deterministic,
and the laggard-first step order is deterministic — so a fleet run is
reproducible end to end.  Bit-identity is stronger and holds by
construction: a session's token stream depends only on each request's
own prompt and sampling (never on batch-mates or admission timing), so
the tokens a routed request gets equal the tokens the same prompt gets
from a solo unrouted session (``tests/test_router.py`` asserts this).
"""

from __future__ import annotations

import itertools
from typing import Mapping

import numpy as np

from repro_torch.obs import NULL_OBS
from repro_torch.router.policy import RoutingPolicy
from repro_torch.router.pool import DRAINING, ReplicaPool
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.metrics import aggregate_requests, request_record
from repro_torch.serving.sampling import SamplingParams

__all__ = ["FrontEnd", "parse_request"]

_SAMPLING_KEYS = ("temperature", "top_k", "top_p", "seed")


def parse_request(request: Mapping):
    """OpenAI-style dict -> the session submit arguments.

    Recognized keys: ``prompt`` (token ids, required), ``max_tokens``
    (or ``max_new``), ``tenant``, ``stop`` (token ids), ``arrival``
    (modeled seconds), ``slo_class``, and the sampling quartet
    ``temperature``/``top_k``/``top_p``/``seed`` (any present builds a
    :class:`SamplingParams`; none means greedy).  Unknown keys raise —
    silently dropping a misspelled ``temprature`` would change outputs.
    """
    known = {"prompt", "max_tokens", "max_new", "tenant", "stop",
             "arrival", "slo_class", *_SAMPLING_KEYS}
    unknown = set(request) - known
    if unknown:
        raise ValueError(f"unknown request keys: {sorted(unknown)}")
    if "prompt" not in request:
        raise ValueError("request needs a 'prompt' (token ids)")
    prompt = np.asarray(request["prompt"]).reshape(-1).astype(np.int64)
    if "max_tokens" in request and "max_new" in request:
        raise ValueError("give 'max_tokens' or 'max_new', not both")
    max_new = int(request.get("max_tokens", request.get("max_new", 16)))
    sampling = None
    if any(k in request for k in _SAMPLING_KEYS):
        sampling = SamplingParams(
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 0.0)),
            seed=int(request.get("seed", 0)))
    return prompt, max_new, {
        "stop_ids": tuple(int(t) for t in request.get("stop", ())),
        "sampling": sampling,
        "arrival": (float(request["arrival"])
                    if "arrival" in request else None),
        "slo_class": str(request.get("slo_class", "")),
        "tenant": str(request.get("tenant", "")),
    }


# the historical private name, kept for external patch points
_parse_request = parse_request


class FrontEnd:
    """Route requests across a :class:`ReplicaPool` with one policy.

    ``max_queue_depth`` bounds each replica's *waiting* queue at
    admission: replicas at or over the bound are not candidates, and
    when no live replica is under it the submission is shed with
    ``reason="router_overload"`` before any session is touched.
    ``None`` (default) never sheds at the router tier — sessions still
    enforce their own capacity/overload rejections, which the front end
    propagates (counted per replica as ``shed``).
    """

    def __init__(self, pool: ReplicaPool, policy: RoutingPolicy, *,
                 max_queue_depth: int | None = None, obs=None):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        self.pool = pool
        self.policy = policy
        self.max_queue_depth = max_queue_depth
        self.obs = obs if obs is not None else NULL_OBS
        self.router_rejections = 0      # shed at the router tier
        self._routes: dict[int, tuple[str, int]] = {}
        self._rid = itertools.count()

    # -- obs helpers ------------------------------------------------------
    def _count(self, name: str, help: str, **labels) -> None:
        if self.obs.enabled:
            self.obs.registry.counter(name, help, labels=labels).inc()

    # -- admission --------------------------------------------------------
    def submit(self, request: Mapping) -> int:
        """Route one request; returns its global id.

        Raises the typed :class:`RequestRejected` on router-tier shed
        (``no_live_replicas`` / ``router_overload``) or on the chosen
        replica's own front-door rejection (``capacity`` / ``overload``,
        re-raised unchanged with the replica name attached as
        ``.replica``)."""
        prompt, max_new, kw = _parse_request(request)
        live = self.pool.live()
        if not live:
            self.router_rejections += 1
            self._count("kvswap_router_rejections_total",
                        "router-tier shed submissions",
                        reason="no_live_replicas")
            raise RequestRejected(
                "no_live_replicas",
                "every replica is draining or quiesced",
                n_replicas=len(self.pool))
        if self.max_queue_depth is not None:
            candidates = [r for r in live
                          if r.session.queue_depth < self.max_queue_depth]
            if not candidates:
                self.router_rejections += 1
                self._count("kvswap_router_rejections_total",
                            "router-tier shed submissions",
                            reason="router_overload")
                raise RequestRejected(
                    "router_overload",
                    f"all {len(live)} live replicas are at "
                    f"max_queue_depth={self.max_queue_depth}",
                    max_queue_depth=self.max_queue_depth,
                    live_replicas=len(live))
        else:
            candidates = live
        rep = self.policy.choose(candidates, prompt, request)
        try:
            local = rep.session.submit(prompt, max_new, **kw)
        except RequestRejected as exc:
            rep.shed += 1
            self._count("kvswap_router_replica_rejections_total",
                        "replica front-door rejections seen by the router",
                        replica=rep.name)
            exc.replica = rep.name
            raise
        rep.routed += 1
        self._count("kvswap_router_requests_total",
                    "requests routed, by replica", replica=rep.name)
        rid = next(self._rid)
        self._routes[rid] = (rep.name, local)
        return rid

    # -- the lockstep scheduler loop --------------------------------------
    def _maybe_quiesce(self) -> None:
        """Auto-complete drains: a draining replica whose work just ran
        dry quiesces immediately (stats frozen, session closed) — the
        caller asked for the drain; finishing it needs no second call."""
        for rep in self.pool:
            if rep.state == DRAINING and not rep.session.has_work:
                self.pool.quiesce(rep.name)

    def step(self) -> list[dict]:
        """One lockstep iteration: step the laggard replica (minimum
        ``session.now`` among steppable replicas, ties to pool order).
        Returns that replica's scheduler events with a ``"replica"`` key
        stamped on each; an idle fleet returns ``[]``."""
        todo = self.pool.steppable()
        if not todo:
            return []
        rep = min(todo, key=lambda r: r.session.now)
        events = rep.session.step()
        for ev in events:
            ev["replica"] = rep.name
        self._maybe_quiesce()
        return events

    def step_until(self, t: float) -> list[dict]:
        """Advance every replica whose clock is behind ``t`` (the
        replay loop's synchronizer: before routing a trace arrival, the
        fleet's clocks catch up to it so load and affinity signals are
        read *at* the arrival, not at some stale past)."""
        events: list[dict] = []
        while True:
            todo = [r for r in self.pool.steppable() if r.session.now < t]
            if not todo:
                return events
            rep = min(todo, key=lambda r: r.session.now)
            evs = rep.session.step()
            for ev in evs:
                ev["replica"] = rep.name
            events.extend(evs)
            self._maybe_quiesce()

    def drain(self) -> dict[int, np.ndarray]:
        """Run the fleet to completion (lockstep order throughout);
        returns every completed request's tokens by global id."""
        while self.pool.steppable():
            self.step()
        return self.results()

    # -- results ----------------------------------------------------------
    def _completed(self, rid: int):
        name, local = self._routes[rid]
        return self.pool[name].session.completed.get(local)

    def results(self) -> dict[int, np.ndarray]:
        out = {}
        for rid in self._routes:
            req = self._completed(rid)
            if req is not None:
                out[rid] = req.output
        return out

    def result(self, rid: int) -> np.ndarray:
        req = self._completed(rid)
        if req is None:
            raise KeyError(f"request {rid} has not completed")
        return req.output

    def route_of(self, rid: int) -> str:
        """Which replica served global request ``rid`` (test/debug aid)."""
        return self._routes[rid][0]

    # -- stats ------------------------------------------------------------
    def stats(self) -> dict:
        """Fleet view: per-replica snapshots plus cross-replica totals.

        ``makespan_s`` is the max replica clock (the fleet finishes when
        its last replica does); fleet goodput and the warm-prefill /
        prefix hit rates are recomputed from summed numerators and
        denominators, never averaged across replicas."""
        per = {rep.name: rep.snapshot() for rep in self.pool}
        sessions = [p["session"] for p in per.values()]

        def total(key):
            return sum(s[key] for s in sessions)

        makespan = max((p["now"] for p in per.values()), default=0.0)
        tokens = total("completed_tokens")
        prompt_tokens = total("prompt_tokens")
        cached = total("cached_prompt_tokens")
        return {
            "replicas": per,
            "n_replicas": len(self.pool),
            "policy": self.policy.name,
            "completed_requests": total("completed_requests"),
            "completed_tokens": tokens,
            "failed_requests": total("failed_requests"),
            "rejected_requests": total("rejected_requests"),
            "router_rejections": self.router_rejections,
            "routed_requests": sum(p["routed"] for p in per.values()),
            "makespan_s": makespan,
            "goodput_tokens_per_s": tokens / makespan if makespan else 0.0,
            "prompt_tokens": prompt_tokens,
            "cached_prompt_tokens": cached,
            "prefix_hit_rate": (cached / prompt_tokens
                                if prompt_tokens else 0.0),
        }

    def aggregate(self, slo_classes: Mapping) -> dict:
        """Per-request SLO aggregation across the fleet — the same
        :func:`aggregate_requests` path the single-session trace harness
        uses, over records re-stamped with global rids and a
        ``"replica"`` key, with the fleet makespan as the denominator."""
        records = []
        for rid, (name, local) in sorted(self._routes.items()):
            req = self.pool[name].session.completed.get(local)
            if req is None:
                continue
            rec = request_record(req)
            rec["rid"] = rid
            rec["replica"] = name
            records.append(rec)
        makespan = max((rep.now for rep in self.pool), default=0.0)
        agg = aggregate_requests(records, slo_classes, makespan_s=makespan)
        return {**agg, "per_request": records}

    # -- trace replay ------------------------------------------------------
    def replay(self, trace) -> dict:
        """Route a :class:`~repro_torch.serving.trace.Trace` through the fleet
        as-it-arrives: clocks catch up to each arrival
        (:meth:`step_until`) before it is routed, so every routing
        decision sees live load/affinity signals; then the fleet drains.

        Shed submissions (router- or replica-tier) are part of the
        measurement near saturation — they are counted in :meth:`stats`,
        not retried.  Returns the fleet SLO aggregation plus the stats
        view under ``"fleet"``."""
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
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
