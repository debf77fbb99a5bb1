"""Versioned, seed-deterministic serving traces + replay.

The port of :mod:`repro.serving.trace` (numpy only): the same trace format,
generators and seeds, so a trace file written by either package replays
through the other; :func:`replay` drives the port's
:class:`~repro_torch.serving.api.ServeSession` and reads the same
``_waiting`` / ``_active()`` hooks.  Nothing else differs.

The serving benchmarks so far drive ad-hoc arrival patterns built inline;
nothing is replayable across configs or PRs.  This module pins the workload
as data: a **trace** is a JSONL file — one header line plus one line per
request — that fully determines a serving run on the modeled clock, so the
same file replayed through any :class:`~repro_torch.serving.api.ServeSession`
(nvme/ufs/emmc × warm tier × prefix cache × …) yields directly comparable
TTFT/TPOT/SLO numbers.  It is the standing yardstick later serving PRs
(affinity routing, disaggregated prefill, lookahead prefetch) are judged
against.

Format (version 2)::

    {"format": "kvswap-trace", "version": 2, "workload": "chat", "seed": 7,
     "vocab_size": 512, "slo_classes": {"interactive":
     {"ttft_s": 0.25, "tpot_s": 0.05}, ...}}
    {"rid": 0, "arrival": 0.0, "max_new": 12, "slo_class": "interactive",
     "tenant": "t0", "segments": [[7000003, 48], [7000004, 16]]}
    ...

Version history: v1 had no ``tenant`` field; v2 adds it (written only
when non-empty, read as ``""`` when absent), so every v1 file loads
unchanged while future versions are still rejected.

Prompts are stored as **segments** — ``[seed, n_tokens]`` pairs
materialized with ``np.random.default_rng(seed)`` — rather than literal
token arrays.  Two requests that share a segment list prefix share the
exact same token prefix, which is what makes the multi-turn chat workload
prefix-cache-heavy *by construction* while keeping trace files tiny and
the whole thing seed-deterministic.  Literal ``tokens`` are also accepted
for hand-written traces.

SLO classes are baked into the header at generation time: every replay of
a trace judges attainment against the same contract, so "warm tier on" vs
"off" differ only in the serving stack, never in the goalposts.

Three generators cover the paper's workload shapes:

* :func:`chat_trace` — multi-turn conversations; turn ``t``'s prompt is
  turn ``t-1``'s prompt plus one new user segment (prefix-reuse heavy).
* :func:`doc_trace` — long-document summarization: long prompts, short
  outputs (prefill heavy).
* :func:`burst_trace` — Poisson interarrival bursts separated by quiet
  gaps, mixed SLO classes (queueing heavy).
* :func:`mixed_tenant_trace` — interleaved per-tenant chat conversations
  tagged with ``tenant`` labels (the affinity-routing shape).

Determinism contract: replaying the same trace through an identically
configured **synchronous** session is bit-deterministic end to end
(tokens, timestamps, metrics JSON).  ``async_io=True`` keeps tokens
bit-identical but accumulates accountant floats in thread order, so the
harness replays with ``async_io=False``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence

import numpy as np

from repro_torch.serving.metrics import (SLOClass, aggregate_requests,
                                   per_request_breakdown)

TRACE_FORMAT = "kvswap-trace"
TRACE_VERSION = 2

# Segment seeds are derived as ``trace_seed * _SEED_STRIDE + counter`` — a
# plain affine map keeps them stable, collision-free within a trace, and
# obvious in the JSONL (seed 7 → segments 7000003, 7000004, ...).
_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request line: when it arrives, what it asks for, how it is
    judged.  ``segments`` is a tuple of ``(seed, n_tokens)`` pairs;
    ``tokens`` (explicit ids) overrides it when set."""

    rid: int
    arrival: float
    max_new: int
    slo_class: str = ""
    tenant: str = ""
    segments: tuple[tuple[int, int], ...] = ()
    tokens: tuple[int, ...] | None = None

    @property
    def prompt_tokens(self) -> int:
        if self.tokens is not None:
            return len(self.tokens)
        return sum(n for _, n in self.segments)

    def materialize(self, vocab_size: int) -> np.ndarray:
        """The prompt ids, ``[S] int64`` — identical for identical
        ``(segments, vocab_size)`` on every replay."""
        if self.tokens is not None:
            return np.asarray(self.tokens, dtype=np.int64)
        if not self.segments:
            raise ValueError(f"trace request {self.rid} has no prompt")
        parts = [np.random.default_rng(seed).integers(
                     0, vocab_size, size=n, dtype=np.int64)
                 for seed, n in self.segments]
        return np.concatenate(parts)

    def to_line(self) -> dict:
        d = {"rid": self.rid, "arrival": self.arrival,
             "max_new": self.max_new, "slo_class": self.slo_class}
        if self.tenant:
            d["tenant"] = self.tenant
        if self.tokens is not None:
            d["tokens"] = list(self.tokens)
        else:
            d["segments"] = [list(s) for s in self.segments]
        return d

    @classmethod
    def from_line(cls, d: Mapping) -> "TraceRequest":
        return cls(rid=int(d["rid"]), arrival=float(d["arrival"]),
                   max_new=int(d["max_new"]),
                   slo_class=str(d.get("slo_class", "")),
                   tenant=str(d.get("tenant", "")),
                   segments=tuple((int(s), int(n))
                                  for s, n in d.get("segments", [])),
                   tokens=(tuple(int(t) for t in d["tokens"])
                           if "tokens" in d else None))


@dataclasses.dataclass
class Trace:
    """A replayable workload: header metadata + ordered request lines."""

    workload: str
    seed: int
    vocab_size: int
    slo_classes: dict[str, SLOClass]
    requests: list[TraceRequest]
    version: int = TRACE_VERSION

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def prompts(self) -> list[np.ndarray]:
        return [r.materialize(self.vocab_size) for r in self.requests]

    # -- serialization ----------------------------------------------------
    def save(self, path) -> None:
        header = {
            "format": TRACE_FORMAT, "version": self.version,
            "workload": self.workload, "seed": self.seed,
            "vocab_size": self.vocab_size,
            "slo_classes": {n: c.to_dict()
                            for n, c in sorted(self.slo_classes.items())},
        }
        with open(path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for r in sorted(self.requests, key=lambda r: r.rid):
                f.write(json.dumps(r.to_line(), sort_keys=True) + "\n")

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
        if not lines:
            raise ValueError(f"empty trace file: {path}")
        header = json.loads(lines[0])
        if header.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"not a {TRACE_FORMAT} file (format={header.get('format')!r})")
        if int(header.get("version", -1)) > TRACE_VERSION:
            raise ValueError(
                f"trace version {header['version']} is newer than this "
                f"reader (supports <= {TRACE_VERSION})")
        classes = {name: SLOClass(name=name, ttft_s=float(c["ttft_s"]),
                                  tpot_s=float(c["tpot_s"]))
                   for name, c in header.get("slo_classes", {}).items()}
        return cls(workload=str(header["workload"]),
                   seed=int(header["seed"]),
                   vocab_size=int(header["vocab_size"]),
                   slo_classes=classes,
                   requests=[TraceRequest.from_line(json.loads(ln))
                             for ln in lines[1:]],
                   version=int(header["version"]))


# -- generators -----------------------------------------------------------
class _SegmentSeeds:
    """Collision-free per-trace segment seed allocator."""

    def __init__(self, trace_seed: int):
        self.base = trace_seed * _SEED_STRIDE
        self.n = 0

    def next(self) -> int:
        self.n += 1
        return self.base + self.n


def chat_trace(seed: int, *, conversations: int = 4, turns: int = 4,
               sys_tokens: int = 48, user_tokens: int = 16,
               max_new: int = 12, turn_gap_s: float = 1.0,
               conv_gap_s: float = 0.5,
               slo_classes: Mapping[str, SLOClass],
               slo_class: str = "interactive",
               vocab_size: int = 512) -> Trace:
    """Multi-turn chat: each conversation opens with a system segment; turn
    ``t``'s prompt is the previous turn's prompt plus one fresh user
    segment, so consecutive turns share an ever-growing token prefix — the
    prefix-cache-heavy shape.  Turn arrivals are spaced by think-time gaps
    ``>= turn_gap_s`` (calibrate ``turn_gap_s`` to roughly one turn's
    service time so turn ``t`` lands after turn ``t-1`` retired and can
    actually hit the published prefix)."""
    rng = np.random.default_rng(seed)
    seeds = _SegmentSeeds(seed)
    reqs: list[TraceRequest] = []
    rid = 0
    start = 0.0
    for _ in range(conversations):
        start += conv_gap_s * rng.exponential()
        segs: list[tuple[int, int]] = [(seeds.next(), sys_tokens)]
        t = start
        for turn in range(turns):
            if turn:
                t += turn_gap_s * (1.0 + 0.3 * rng.exponential())
            segs.append((seeds.next(), user_tokens))
            reqs.append(TraceRequest(rid=rid, arrival=round(t, 9),
                                     max_new=max_new, slo_class=slo_class,
                                     segments=tuple(segs)))
            rid += 1
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    reqs = [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]
    return Trace(workload="chat", seed=seed, vocab_size=vocab_size,
                 slo_classes=dict(slo_classes), requests=reqs)


def doc_trace(seed: int, *, n_requests: int = 6,
              doc_tokens: Sequence[int] = (192, 256), max_new: int = 8,
              interarrival_s: float = 1.0,
              slo_classes: Mapping[str, SLOClass],
              slo_class: str = "batch",
              vocab_size: int = 512) -> Trace:
    """Long-document summarization: long unique prompts (drawn from a small
    length set so prefill chunk shapes stay jit-friendly), short outputs,
    Poisson arrivals — the prefill-heavy shape."""
    rng = np.random.default_rng(seed)
    seeds = _SegmentSeeds(seed)
    reqs, t = [], 0.0
    for rid in range(n_requests):
        if rid:
            t += interarrival_s * rng.exponential()
        n = int(rng.choice(np.asarray(doc_tokens)))
        reqs.append(TraceRequest(rid=rid, arrival=round(t, 9),
                                 max_new=max_new, slo_class=slo_class,
                                 segments=((seeds.next(), n),)))
    return Trace(workload="doclong", seed=seed, vocab_size=vocab_size,
                 slo_classes=dict(slo_classes), requests=reqs)


def burst_trace(seed: int, *, bursts: int = 4, burst_size: int = 4,
                quiet_s: float = 2.0, within_s: float = 0.05,
                prompt_tokens: Sequence[int] = (32, 48, 64),
                max_new_choices: Sequence[int] = (6, 12),
                slo_classes: Mapping[str, SLOClass],
                class_cycle: Sequence[str] = ("interactive", "bulk"),
                vocab_size: int = 512) -> Trace:
    """Poisson interarrival bursts: ``burst_size`` requests arrive within
    ``~within_s`` gaps, then a quiet period ``~quiet_s`` — the queueing-
    heavy shape that separates TTFT p50 from p95/p99.  SLO classes cycle
    across requests so per-class attainment is exercised."""
    rng = np.random.default_rng(seed)
    seeds = _SegmentSeeds(seed)
    reqs, rid, t = [], 0, 0.0
    for _ in range(bursts):
        t += quiet_s * (0.5 + 0.5 * rng.exponential())
        a = t
        for _ in range(burst_size):
            a += within_s * rng.exponential()
            n = int(rng.choice(np.asarray(prompt_tokens)))
            m = int(rng.choice(np.asarray(max_new_choices)))
            reqs.append(TraceRequest(
                rid=rid, arrival=round(a, 9), max_new=m,
                slo_class=class_cycle[rid % len(class_cycle)],
                segments=((seeds.next(), n),)))
            rid += 1
    return Trace(workload="burst", seed=seed, vocab_size=vocab_size,
                 slo_classes=dict(slo_classes), requests=reqs)


def mixed_tenant_trace(seed: int, *, tenants: int = 3, turns: int = 4,
                       sys_tokens: int = 48, user_tokens: int = 16,
                       max_new: int = 12, turn_gap_s: float = 1.0,
                       start_spread_s: float = 0.5,
                       slo_classes: Mapping[str, SLOClass],
                       slo_class: str = "interactive",
                       vocab_size: int = 512) -> Trace:
    """Interleaved multi-tenant chat — the affinity-routing workload.

    Each tenant ``t{i}`` runs one growing conversation (system segment +
    one fresh user segment per turn, exactly the :func:`chat_trace`
    prefix-reuse shape) tagged with its tenant label.  Tenant start
    offsets and think-time gaps are exponential draws, so the merged
    arrival stream **interleaves** tenants: a round-robin router sprays
    one tenant's turns across replicas (each replica holds a fragment of
    the prefix chain), while a prefix-affinity router keeps every turn on
    the replica that already caches the conversation — the spread this
    trace exists to expose."""
    rng = np.random.default_rng(seed)
    seeds = _SegmentSeeds(seed)
    reqs: list[TraceRequest] = []
    rid = 0
    for i in range(tenants):
        t = start_spread_s * rng.exponential()
        segs: list[tuple[int, int]] = [(seeds.next(), sys_tokens)]
        for turn in range(turns):
            if turn:
                t += turn_gap_s * (1.0 + 0.3 * rng.exponential())
            segs.append((seeds.next(), user_tokens))
            reqs.append(TraceRequest(rid=rid, arrival=round(t, 9),
                                     max_new=max_new, slo_class=slo_class,
                                     tenant=f"t{i}",
                                     segments=tuple(segs)))
            rid += 1
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    reqs = [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]
    return Trace(workload="mixed_tenant", seed=seed, vocab_size=vocab_size,
                 slo_classes=dict(slo_classes), requests=reqs)


GENERATORS = {"chat": chat_trace, "doclong": doc_trace, "burst": burst_trace,
              "mixed_tenant": mixed_tenant_trace}


# -- replay ---------------------------------------------------------------
def replay(trace: Trace, session) -> dict:
    """Replay ``trace`` through a fresh :class:`~repro_torch.serving.api.
    ServeSession` on the modeled clock and aggregate the per-request view.

    The session must be empty (no prior submissions); its prefix cache,
    engine config and disk tier are exactly what is being measured.  Only
    modeled/deterministic quantities appear in the result — measured
    wall-clock stays out so the metrics JSON is byte-stable across runs
    (asserted by ``tests/test_trace.py``; replay with ``async_io=False``
    for full byte-determinism, see the module docstring).
    """
    if session.completed or session._waiting or session._active():
        raise ValueError("replay() needs a fresh, idle session")
    for r in trace.requests:
        session.submit(r.materialize(trace.vocab_size), r.max_new,
                       arrival=r.arrival, slo_class=r.slo_class,
                       tenant=r.tenant)
    session.drain()
    records = per_request_breakdown(session.completed.values())
    agg = aggregate_requests(records, trace.slo_classes,
                             makespan_s=session.now)
    s = session.stats()
    engine_view = {k: s.get(k, 0.0) for k in (
        "completed_requests", "completed_tokens", "decode_steps",
        "reuse_ratio", "read_bytes", "warm_bytes", "warm_hit_rate",
        "io_seconds", "compute_seconds", "pipelined_seconds",
        "overlap_saved_seconds", "step_seconds_p50", "step_seconds_p95",
        "step_seconds_p99",
        # prefetch quality (repro_torch.obs.quality, pooled over the replay's
        # steady-state window): predictor precision/recall as 1-step
        # lookahead, and the reuse-resident-but-unselected rate
        "pred_precision", "pred_recall", "stale_group_rate")}
    cached = sum(r["cached_tokens"] for r in records)
    return {
        "workload": trace.workload,
        "trace_seed": trace.seed,
        "n_requests": trace.n_requests,
        "cached_prompt_tokens": cached,
        **agg,
        "per_request": records,
        "engine": engine_view,
    }
