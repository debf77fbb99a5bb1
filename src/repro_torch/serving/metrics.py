"""Per-request serving metrics: lifecycle breakdown, latency percentiles,
SLO attainment, goodput-under-SLO.

:func:`repro.core.engine.summarize_steps` aggregates *per-step* engine
accounting; nothing in the repo aggregated *per-request* latency until the
trace harness needed it.  This module is that single aggregation path —
the SLO benchmark, ``ServeSession.per_request()`` and any future routing
work all report TTFT/TPOT/attainment through these helpers, so the numbers
are comparable by construction.

Definitions (all on the session's modeled clock):

* ``wait_seconds``   — ``admitted_at - arrival``.  Admission charges the
  request's own modeled prefill to the clock *before* stamping
  ``admitted_at``, so this is queueing + prefill (time to leave the queue
  with KV ready).
* ``ttft_seconds``   — ``first_token_at - arrival``: what an interactive
  user sees before the first token.
* ``tpot_seconds``   — ``(finished_at - first_token_at) / (tokens - 1)``,
  the mean inter-token gap after the first token; ``0.0`` for single-token
  requests (no gap exists).
* ``e2e_seconds``    — ``finished_at - arrival``.
* SLO attainment     — a request **meets** its class when
  ``ttft <= class.ttft_s`` and ``tpot <= class.tpot_s``; classes the trace
  did not declare never match (attainment requires an explicit contract).
* goodput-under-SLO  — completed tokens of SLO-meeting requests per modeled
  second, the serving-quality headline: tokens delivered late count toward
  raw goodput but not toward this.

Everything here is pure Python over completed :class:`~repro.serving.api.
Request` records and is deterministic given deterministic inputs, so
``json.dumps(..., sort_keys=True)`` of these dicts is byte-stable — the
property the trace-replay determinism test pins.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.utils.stats import percentiles


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency contract: a request meets it when TTFT and TPOT are both
    within bound.  Bounds are modeled seconds, baked into the trace header
    at generation time so every replay of a trace judges against the same
    contract."""

    name: str
    ttft_s: float
    tpot_s: float

    def met_by(self, record: Mapping) -> bool:
        return (record["ttft_seconds"] <= self.ttft_s
                and record["tpot_seconds"] <= self.tpot_s)

    def to_dict(self) -> dict:
        return {"ttft_s": self.ttft_s, "tpot_s": self.tpot_s}


def request_record(req) -> dict:
    """Flatten one completed :class:`~repro.serving.api.Request` into its
    lifecycle breakdown.  Raises if the request never finished — partial
    lifecycles have no TTFT/TPOT and silently skipping them would inflate
    attainment."""
    if req.finished_at is None or req.first_token_at is None:
        raise ValueError(f"request {req.rid} has not completed")
    tokens = int(len(req.output))
    ttft = req.first_token_at - req.arrival
    tpot = ((req.finished_at - req.first_token_at) / (tokens - 1)
            if tokens > 1 else 0.0)
    return {
        "rid": req.rid,
        "slo_class": req.slo_class,
        "tenant": req.tenant,
        "arrival": req.arrival,
        "admitted_at": req.admitted_at,
        "first_token_at": req.first_token_at,
        "finished_at": req.finished_at,
        "wait_seconds": req.admitted_at - req.arrival,
        "ttft_seconds": ttft,
        "tpot_seconds": tpot,
        "e2e_seconds": req.finished_at - req.arrival,
        "tokens": tokens,
        "prompt_tokens": int(req.prompt.shape[0]),
        "cached_tokens": int(req.cached_tokens),
        "restored_tokens": int(getattr(req, "restored_tokens", 0)),
        "stopped_early": bool(req.stopped_early),
    }


def publish_request(registry, record: Mapping) -> None:
    """Mirror one completed request's lifecycle into a metrics registry
    (:class:`repro.obs.MetricsRegistry`): request/token counters plus
    TTFT/TPOT/e2e/wait histograms.  :class:`~repro.serving.api.ServeSession`
    calls this at retirement when an obs handle is attached; the histograms
    observe the exact values :func:`request_record` reports, so registry
    quantiles agree with :func:`aggregate_requests` (same samples, same
    percentile helper)."""
    registry.counter("kvswap_requests_completed_total",
                     "requests served to completion").inc()
    registry.counter("kvswap_requests_tokens_total",
                     "tokens generated for completed requests"
                     ).inc(record["tokens"])
    if record["stopped_early"]:
        registry.counter("kvswap_requests_stopped_early_total",
                         "requests ended by a stop token").inc()
    registry.histogram("kvswap_request_ttft_seconds",
                       "modeled time to first token"
                       ).observe(record["ttft_seconds"])
    registry.histogram("kvswap_request_tpot_seconds",
                       "modeled mean inter-token gap"
                       ).observe(record["tpot_seconds"])
    registry.histogram("kvswap_request_e2e_seconds",
                       "modeled end-to-end latency"
                       ).observe(record["e2e_seconds"])
    registry.histogram("kvswap_request_wait_seconds",
                       "modeled queue wait + prefill"
                       ).observe(record["wait_seconds"])


def per_request_breakdown(requests: Iterable) -> list[dict]:
    """Records for every completed request, ordered by rid (submission
    order — stable regardless of completion interleaving)."""
    return [request_record(r)
            for r in sorted(requests, key=lambda r: r.rid)]


def aggregate_requests(records: Iterable[Mapping],
                       slo_classes: Mapping[str, SLOClass] | None = None,
                       *, makespan_s: float | None = None) -> dict:
    """Fleet-level view of a replay: TTFT/TPOT p50/p95/p99, per-class SLO
    attainment, goodput and goodput-under-SLO.

    ``makespan_s`` is the modeled clock at the end of the replay (the
    session's ``now``); without it the goodput rates are omitted.  Requests
    whose ``slo_class`` has no entry in ``slo_classes`` count as *missing*
    their SLO (an undeclared contract cannot be met) and are reported under
    ``unclassified`` so the mismatch is visible rather than silent.
    """
    records = list(records)
    slo_classes = dict(slo_classes or {})
    met_tokens = 0
    by_class: dict[str, dict] = {}
    for rec in records:
        name = rec["slo_class"]
        cls = slo_classes.get(name)
        bucket = by_class.setdefault(
            name if cls is not None else "unclassified",
            {"requests": 0, "met": 0, "tokens": 0})
        ok = cls is not None and cls.met_by(rec)
        bucket["requests"] += 1
        bucket["met"] += int(ok)
        bucket["tokens"] += rec["tokens"]
        if ok:
            met_tokens += rec["tokens"]
    for name, bucket in by_class.items():
        bucket["attainment"] = bucket["met"] / bucket["requests"]
        if name in slo_classes:
            bucket.update(slo_classes[name].to_dict())
    tokens = sum(r["tokens"] for r in records)
    out = {
        "requests": len(records),
        "tokens": tokens,
        "ttft": percentiles([r["ttft_seconds"] for r in records]),
        "tpot": percentiles([r["tpot_seconds"] for r in records]),
        "e2e": percentiles([r["e2e_seconds"] for r in records]),
        "slo": by_class,
        "slo_attainment": (sum(b["met"] for b in by_class.values())
                           / len(records) if records else 0.0),
        "slo_met_tokens": met_tokens,
    }
    if makespan_s is not None:
        out["makespan_seconds"] = makespan_s
        out["goodput_tokens_per_s"] = tokens / makespan_s if makespan_s else 0.0
        out["goodput_under_slo_tokens_per_s"] = (
            met_tokens / makespan_s if makespan_s else 0.0)
    return out
