"""Continuous-batching serving API: persistent engine, per-slot lifecycle.

The PyTorch port of :mod:`repro.serving.api`; the scheduling is the
reference's, unchanged.  The engine hands back logits as device tensors,
which the session pulls to the host with ``.cpu().numpy()`` where the
reference used ``np.asarray``.

The paper's deployment scenario is batched on-device serving (Tab. 4, batch
1-16); serving-as-a-service systems for this setting (LLMS, LMCache) treat
the engine as a **long-lived resource** with per-request admission and KV
lifecycle.  This module is that front end for the KVSwap runtime:

* one :class:`~repro_torch.core.engine.KVSwapEngine` lives for the whole
  :class:`ServeSession` — no per-batch construction/teardown, and the
  prefix cache, reuse buffers, device mirrors and jit caches all stay warm;
* each engine batch row is a **slot** with its own request lifecycle::

      FREE --admit_row()--> RUNNING --stop/max_new--> (publish) --retire_row()--> FREE
                               |
                               +--> decoding: active-mask on, reads charged
                               '--> masked:  inactive, zero reads, zero time

* :meth:`ServeSession.step` is one scheduler iteration: admit due requests
  into free slots, sample one token per running slot, retire finished
  slots (publishing their served KV to the prefix cache first), and run one
  engine decode step over the remaining active rows.

Time is **modeled** (the DiskSpec/ComputeSpec accountants): the session
clock advances by each admission's modeled prefill seconds and each decode
step's pipelined seconds, and requests carry an ``arrival`` timestamp on
that clock — which is what lets a benchmark drive a Poisson arrival trace
deterministically (``benchmarks/continuous_serving.py``).

Determinism contract: a request's token stream depends only on its own
prompt and sampling state — never on which slot it lands in, who shares the
batch, or when it was admitted.  For identical arrival patterns the session
emits tokens bit-identical to the static lockstep path
(``tests/test_serving_api.py`` asserts this across ``device_resident`` ×
``async_io``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Iterator, Sequence

import numpy as np

from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.faults.errors import StorageFault
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.sampling import SamplingParams, make_row_sampler

WAITING, RUNNING, DONE, FAILED = "waiting", "running", "done", "failed"


@dataclasses.dataclass
class Request:
    """One serving request and its full lifecycle record."""

    rid: int
    prompt: np.ndarray                  # [S] int
    max_new: int
    stop_ids: tuple = ()
    sampling: SamplingParams | None = None
    arrival: float = 0.0                # modeled seconds on the session clock
    slo_class: str = ""                 # trace-harness SLO class label
    tenant: str = ""                    # opaque tenant label (routing/affinity)
    # raw ``logits [1, V] -> ids [1]`` override (BatchServer compatibility);
    # prefer ``sampling`` for new code
    sampler: Callable | None = dataclasses.field(default=None, repr=False)
    # filled in by the session — the full lifecycle on the modeled clock:
    #   arrival <= admitted_at <= first_token_at <= finished_at
    # (admitted_at already includes the admission's own modeled prefill;
    # first_token_at == admitted_at unless later admissions in the same
    # scheduler iteration charged their prefills before the sampling pass)
    output: np.ndarray | None = None    # [<= max_new] generated ids
    stopped_early: bool = False         # hit a stop token before max_new
    state: str = WAITING
    slot: int | None = None
    admitted_at: float | None = None    # session clock at admission
    first_token_at: float | None = None  # clock when token 0 was sampled
    finished_at: float | None = None
    cached_tokens: int = 0              # prompt tokens restored from the cache
    # admission-time warm-restore coverage, surfaced in request_record so a
    # harness (e.g. the disagg benchmark) can assert per-request restore
    # coverage without reaching into the engine.  Today identical to
    # cached_tokens at admission; kept separate because cached_tokens is
    # also the historical knob external callers mutate.
    restored_tokens: int = 0
    error: str | None = None            # set iff state == FAILED
    # the same lifecycle on the wall clock, ``time.time_ns()`` readings of
    # the session's tracer; set only with an enabled obs handle:
    #   submitted_wall <= admitted_wall <= first_token_wall <= finished_wall
    submitted_wall: int | None = None
    admitted_wall: int | None = None
    first_token_wall: int | None = None
    finished_wall: int | None = None


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Load-shedding ladder for sustained storage latency inflation.

    The session watches decode-step *modeled* latency
    (``pipelined_seconds``): the first ``baseline_steps`` steps establish
    a healthy median, after which a rolling ``window``-step median is
    compared against it.  The ladder (docs/robustness.md):

    * **level 0** — healthy, everything admitted;
    * **level 1** — recent median ≥ ``shed_factor`` × baseline:
      new ``submit()`` calls are rejected (``reason="overload"``) while
      already-admitted requests run to completion;
    * **level 2** — still inflated after shedding and
      ``reduce_n_select=True``: the engine's runtime critical-group
      budget is halved (never below ``min_n_select``), trading accuracy
      for I/O.  Level 2 breaks the bit-identity contract, which is why
      it is opt-in.

    Recovery walks back one level whenever the recent median falls to
    ``recover_factor`` × baseline or better; at level < 2 the group
    budget is restored.
    """

    baseline_steps: int = 16
    window: int = 8
    shed_factor: float = 4.0
    recover_factor: float = 1.5
    reduce_n_select: bool = False
    min_n_select: int = 4

    def __post_init__(self):
        if self.baseline_steps < 1 or self.window < 1:
            raise ValueError("baseline_steps and window must be >= 1")
        if self.recover_factor > self.shed_factor:
            raise ValueError("recover_factor must be <= shed_factor "
                             "(the ladder would oscillate every step)")


class _Slot:
    """Runtime state of one engine row while a request occupies it."""

    def __init__(self, req: Request, sampler: Callable, logits: np.ndarray):
        self.req = req
        self.sampler = sampler
        self.logits = logits            # [1, V] current next-token logits
        self.out: list[int] = []
        self.stop_set = frozenset(int(t) for t in req.stop_ids)


class ServeSession:
    """Persistent continuous-batching session over one KVSwap engine.

    ``slots`` engine rows serve an unbounded request stream: ``submit()``
    enqueues, ``step()`` runs one admission+decode iteration, ``stream()``
    iterates steps yielding events, ``drain()`` runs to completion.  With a
    :class:`~repro_torch.cache.PrefixCache` attached, admissions restore cached
    prefixes and retirements publish served KV back — the cache handle (and
    everything else) outlives every request.
    """

    def __init__(self, model, params, engine_cfg: EngineConfig, *,
                 slots: int, calib_k: np.ndarray | None = None,
                 adapter=None, prefix_cache=None, obs=None,
                 faults=None, degrade: DegradationPolicy | None = None,
                 device=None):
        kinds = getattr(model, "layer_kinds", ("kv",) * model.n_layers)
        if any(k != "kv" for k in kinds):
            raise ValueError(
                "ServeSession requires attention-only models: recurrent "
                "state layers have no per-row admission/retirement")
        if prefix_cache is not None and getattr(model, "kv_planes", 2) == 1:
            raise ValueError("the prefix cache keeps K/V pairs; latent attention (MLA) "
                             "has none to restore or publish")
        self.engine = KVSwapEngine(model, params, engine_cfg, batch=slots,
                                   calib_k=calib_k, adapter=adapter, obs=obs,
                                   faults=faults, device=device)
        # the engine resolves obs=None to the shared NULL_OBS; one handle
        # covers the whole stack so engine spans and request lifecycles
        # land on the same timeline
        self.obs = self.engine.obs
        self.n_slots = slots
        self.prefix_cache = prefix_cache
        if faults is not None and prefix_cache is not None:
            prefix_cache.use_faults(faults)
        self.now = 0.0                  # modeled seconds
        self.published_blocks = 0
        self.completed: dict[int, Request] = {}
        self.failed: dict[int, Request] = {}
        self.rejected = 0               # front-door rejections (never admitted)
        self.recovered_rows = 0         # survivor rows replayed after a fault
        self.publish_failures = 0       # best-effort publishes that errored
        self.save_failures = 0          # manifest saves that errored
        self.degrade = degrade
        self._degrade_level = 0
        self._base_n_select = self.engine.n_select
        self._lat_baseline: list[float] = []
        self._lat_window: collections.deque = collections.deque(
            maxlen=degrade.window if degrade is not None else 1)
        self._rid = itertools.count()
        self._waiting: list[Request] = []
        self._slots: list[_Slot | None] = [None] * slots

    def _count(self, name: str, delta: float = 1) -> None:
        if self.obs.enabled:
            self.obs.registry.counter(name).inc(delta)

    # -- submission ------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, *,
               stop_ids: Sequence[int] = (),
               sampling: SamplingParams | None = None,
               sampler: Callable | None = None,
               arrival: float | None = None,
               slo_class: str = "",
               tenant: str = "") -> int:
        """Enqueue a request; returns its id.  ``arrival`` (modeled seconds)
        defaults to "already here"; future arrivals wait on the clock.
        ``sampler`` overrides ``sampling`` with a raw ``logits -> ids``
        callable (BatchServer compatibility).  ``slo_class`` is an opaque
        label the trace harness uses to bucket attainment per class;
        ``tenant`` is an opaque workload-owner label (the multi-replica
        router keys prefix affinity on it only indirectly — through the
        token prefixes tenants actually share — but it is carried through
        the lifecycle records so per-tenant breakdowns stay possible).

        Refusals raise the typed :class:`~repro_torch.serving.errors.\
RequestRejected` (a ``ValueError``) and count on
        ``kvswap_requests_rejected`` — rejection is pure bookkeeping and
        never touches the engine, so running requests are unperturbed."""
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        n_prompt = int(np.asarray(prompt).reshape(-1).shape[0])
        if n_prompt < 1:
            raise ValueError("empty prompt")
        cap = self.engine.cap_tokens
        if n_prompt + max_new > cap:
            # reject at the front door: admitted-then-overflowing would crash
            # decode_step mid-flight and take the whole batch down with it
            self.rejected += 1
            self._count("kvswap_requests_rejected")
            raise RequestRejected(
                "capacity",
                f"prompt ({n_prompt}) + max_new ({max_new}) exceeds the "
                f"engine's KV capacity ({cap} tokens); raise cfg.max_seq",
                prompt_tokens=n_prompt, max_new=int(max_new), cap_tokens=cap)
        if self._degrade_level >= 1:
            # load shedding (degradation ladder level >= 1): protect the
            # requests already running instead of piling more I/O on a
            # storage stack that is visibly stalling
            self.rejected += 1
            self._count("kvswap_requests_rejected")
            raise RequestRejected(
                "overload",
                f"session is shedding load (degradation level "
                f"{self._degrade_level}); resubmit later",
                degradation_level=self._degrade_level)
        req = Request(rid=next(self._rid),
                      prompt=np.asarray(prompt).reshape(-1).astype(np.int64),
                      max_new=int(max_new), stop_ids=tuple(stop_ids),
                      sampling=sampling, sampler=sampler,
                      arrival=float(self.now if arrival is None else arrival),
                      slo_class=str(slo_class), tenant=str(tenant))
        if self.obs.enabled:
            req.submitted_wall = self.obs.tracer.now_ns()
        self._waiting.append(req)
        return req.rid

    # -- load / lifecycle introspection (the router's cheap signals) ------
    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted (waiting on a slot or on
        their arrival time).  O(1) bookkeeping — routing polls this per
        submission, so it must never touch the engine or build stats."""
        return len(self._waiting)

    @property
    def active_rows(self) -> int:
        """Engine rows currently occupied by running requests."""
        return len(self._active())

    @property
    def has_work(self) -> bool:
        """True while a scheduler iteration would make progress (waiting
        or running requests exist) — the router's lockstep-loop predicate."""
        return bool(self._waiting or self._active())

    @property
    def degradation_level(self) -> int:
        """Current :class:`DegradationPolicy` ladder rung (0 = healthy).
        Public because the affinity router reuses this hysteresis signal
        as its overload penalty — a replica that is already shedding load
        should not attract more, however warm its cache."""
        return self._degrade_level

    # -- scheduling internals --------------------------------------------
    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _admit_due(self, events: list) -> None:
        """Fill free slots with due requests, FIFO by (arrival, rid); each
        admission, its prefill through the logits' readback, is one
        ``serve.admit`` span."""
        self._waiting.sort(key=lambda r: (r.arrival, r.rid))
        on = self.obs.enabled
        for i in range(self.n_slots):
            if self._slots[i] is not None:
                continue
            due = next((r for r in self._waiting if r.arrival <= self.now), None)
            if due is None:
                break
            if on:
                t = self.obs.tracer.now_ns()
            # dequeue only after the admission succeeds, so an admission
            # failure leaves the request visible instead of losing it
            try:
                logits = self.engine.admit_row(i, due.prompt, self.prefix_cache)
            except StorageFault as exc:
                # admit_row rolled the slot back (failure atomicity), so the
                # slot is reusable; the request fails terminally — storage
                # faults are not the submitter's doing, so this is a FAILED
                # outcome, not a rejection
                self._waiting.remove(due)
                due.output = np.asarray([], np.int64)
                self._terminal_failure(due, i, exc, events)
                continue
            self._waiting.remove(due)
            rep = self.engine.prefill_report
            self.now += rep["modeled_seconds"]
            due.state, due.slot, due.admitted_at = RUNNING, i, self.now
            due.cached_tokens = rep["cached_tokens"]
            due.restored_tokens = rep["cached_tokens"]
            sampler = due.sampler or make_row_sampler(due.sampling)
            self._slots[i] = _Slot(due, sampler,
                                   logits.cpu().numpy()[None, :])
            if on:
                due.admitted_wall = self.obs.tracer.phase(
                    "serve.admit", f"admit r{due.rid}", t,
                    {"step": len(self.engine.step_log), "rid": due.rid, "slot": i})
            events.append({"type": "admit", "rid": due.rid, "slot": i,
                           "t": self.now, "cached_tokens": due.cached_tokens})

    def _finish(self, i: int, events: list) -> None:
        slot = self._slots[i]
        req = slot.req
        if self.prefix_cache is not None:
            # publish BEFORE retirement frees the row's disk extents; the
            # engine clamps the history to what is actually on disk
            history = np.concatenate(
                [req.prompt, np.asarray(slot.out, np.int64)])
            # manifest save is deferred to drain()/close(): one rewrite per
            # drain, not one per retirement
            try:
                self.published_blocks += self.engine.publish(
                    self.prefix_cache, tokens={i: history}, rows=[i], save=False)
            except StorageFault:
                # publishing is best-effort cache warming: the request's
                # tokens are already complete, so a failed publish costs
                # future warm prefills, never this request
                self.publish_failures += 1
                self._count("kvswap_publish_failures_total")
        self.engine.retire_row(i)
        req.output = np.asarray(slot.out, np.int64)
        req.state, req.finished_at, req.slot = DONE, self.now, None
        self.completed[req.rid] = req
        self._slots[i] = None
        if self.obs.enabled:
            req.finished_wall = self.obs.tracer.now_ns()
            self._obs_finish(req, i)
        events.append({"type": "finish", "rid": req.rid, "slot": i,
                       "t": self.now, "tokens": len(slot.out),
                       "stopped_early": req.stopped_early})

    def _obs_finish(self, req: Request, i: int) -> None:
        """Request lifecycle on both clocks: a ``queued`` span on the
        shared ``requests`` lane (arrival → admission, which includes the
        admission's own modeled prefill; submission → admission on the
        wall), a ``running`` span on the slot's lane (admission →
        retirement) with a ``first_token`` instant, plus the per-request
        counters/histograms
        (:func:`repro_torch.serving.metrics.publish_request`).  The running
        span's args carry TTFT and TPOT on both clocks.  A handle switched
        on or off between steps leaves some wall readings unset: a span, or
        a figure, missing either of its readings stays off the wall clock."""
        from repro_torch.serving import metrics
        rec = metrics.request_record(req)
        tr = self.obs.tracer
        n = rec["tokens"]

        def wall(t0, t1):
            return (t0, t1) if t0 is not None and t1 is not None else (None, None)

        queued, running, sampled = (wall(req.submitted_wall, req.admitted_wall),
                                    wall(req.admitted_wall, req.finished_wall),
                                    wall(req.first_token_wall, req.finished_wall))
        ttft = wall(req.submitted_wall, req.first_token_wall)
        tr.add(f"r{req.rid} queued", "requests", cat="request",
               wall_t0_ns=queued[0], wall_t1_ns=queued[1],
               model_t0=req.arrival,
               model_dur=req.admitted_at - req.arrival,
               args={"rid": req.rid, "slo_class": req.slo_class,
                     "prompt_tokens": rec["prompt_tokens"],
                     "cached_tokens": rec["cached_tokens"]})
        tr.add(f"r{req.rid}", f"slot{i}", cat="request",
               wall_t0_ns=running[0], wall_t1_ns=running[1],
               model_t0=req.admitted_at,
               model_dur=req.finished_at - req.admitted_at,
               args={"rid": req.rid, "tokens": n,
                     "ttft_s": rec["ttft_seconds"],
                     "tpot_s": rec["tpot_seconds"],
                     "ttft_wall_s": None if ttft[0] is None else (ttft[1] - ttft[0]) / 1e9,
                     "tpot_wall_s": (None if sampled[0] is None else
                                     (sampled[1] - sampled[0]) / 1e9 / (n - 1) if n > 1
                                     else 0.0),
                     "stopped_early": rec["stopped_early"]})
        tr.add("first_token", f"slot{i}", cat="request",
               wall_t0_ns=req.first_token_wall,
               model_t0=req.first_token_at, instant=True,
               args={"rid": req.rid})
        metrics.publish_request(self.obs.registry, rec)

    # -- failure handling (docs/robustness.md) ---------------------------
    def _terminal_failure(self, req: Request, i: int, exc: BaseException,
                          events: list) -> None:
        """Move one request to the FAILED terminal state.  Its partial
        output (possibly empty) stays on ``req.output`` and the typed
        cause on ``req.error``; nothing about any *other* request is
        touched."""
        req.state, req.finished_at, req.slot = FAILED, self.now, None
        req.error = f"{type(exc).__name__}: {exc}"
        self.failed[req.rid] = req
        self._count("kvswap_requests_failed_total")
        if self.obs.enabled:
            self.obs.tracer.add(
                f"r{req.rid} failed", "requests", cat="request",
                model_t0=self.now, instant=True,
                args={"rid": req.rid, "error": req.error})
        events.append({"type": "fail", "rid": req.rid, "slot": i,
                       "t": self.now, "error": req.error})

    def _fail_slot(self, i: int, slot: _Slot, exc: BaseException,
                   events: list) -> None:
        req = slot.req
        req.output = np.asarray(slot.out, np.int64)
        self._slots[i] = None
        self._terminal_failure(req, i, exc, events)

    def _replay_slot(self, i: int, slot: _Slot) -> None:
        """Rebuild one survivor row after a decode fault tore the batch.

        The row is re-admitted cold and every token it has sampled so far
        is decoded back in **alone** (all other rows stay masked out, so
        no bystander state moves).  A row's numeric stream depends only on
        its own state, so the replay reproduces bit-for-bit the KV, tail,
        and logits the row had when the fault hit — including completing
        the decode step that failed.  Modeled replay time is charged to
        the session clock: recovery is visible latency, not free.
        """
        req = slot.req
        logits = self.engine.admit_row(i, req.prompt, None).cpu().numpy()
        self.now += self.engine.prefill_report["modeled_seconds"]
        toks = np.zeros(self.n_slots, dtype=np.int64)
        for tok in slot.out:
            toks[i] = tok
            logits = self.engine.decode_step(toks)[i].cpu().numpy()
            self.now += self.engine.step_log[-1].pipelined_seconds
        slot.logits = logits[None, :]
        # mask the row back out so the next survivor replays alone;
        # _recover_from_decode_fault reactivates every survivor at the end
        self.engine.deactivate_row(i)

    def _recover_from_decode_fault(self, exc: StorageFault,
                                   events: list) -> None:
        """Degradation rung 2: a storage fault escaped the retry budget
        mid-decode.  The failed step left every running row's cross-layer
        state inconsistent (some layers appended, some not), so all rows
        are retired; the culprit request (``exc.row``, attributed by
        :class:`~repro_torch.faults.errors.FetchFailed`) fails terminally and
        every other request is replayed from its recorded tokens.  Without
        attribution the blast radius is the whole running set — still a
        bounded, typed outcome, never a crash."""
        row = getattr(exc, "row", None)
        running = [(i, self._slots[i]) for i in self._active()]
        for i, _ in running:
            self.engine.retire_row(i)
        replayed: list[int] = []
        for i, slot in running:
            if row is None or i == row:
                self._fail_slot(i, slot, exc, events)
                continue
            try:
                self._replay_slot(i, slot)
            except StorageFault as replay_exc:
                # the survivor hit its own unrecoverable fault (e.g. the
                # same grown bad region); free whatever the partial replay
                # left behind and fail it too — bounded, per-request
                self.engine.retire_row(i)
                self._fail_slot(i, slot, replay_exc, events)
                continue
            replayed.append(i)
            self.recovered_rows += 1
            self._count("kvswap_rows_recovered_total")
        for i in replayed:
            self.engine.reactivate_row(i)
        culprit = next((s.req.rid for i, s in running if i == row), None)
        events.append({"type": "recover", "t": self.now,
                       "failed_rid": culprit,
                       "recovered_rows": len(replayed)})

    def _note_step_latency(self, seconds: float) -> None:
        """Feed one decode step's modeled latency to the degradation
        ladder (no-op without a :class:`DegradationPolicy`)."""
        pol = self.degrade
        if pol is None:
            return
        if len(self._lat_baseline) < pol.baseline_steps:
            self._lat_baseline.append(float(seconds))
            return
        self._lat_window.append(float(seconds))
        if len(self._lat_window) < pol.window:
            return
        base = float(np.median(self._lat_baseline))
        if base <= 0.0:
            return
        ratio = float(np.median(self._lat_window)) / base
        max_level = 2 if pol.reduce_n_select else 1
        if ratio >= pol.shed_factor and self._degrade_level < max_level:
            self._degrade_level += 1
            if self._degrade_level == 2:
                self.engine.set_n_select(
                    max(pol.min_n_select, self.engine.n_select // 2))
            self._lat_window.clear()   # fresh window per transition
            self._count("kvswap_degrade_transitions_total")
            if self.obs.enabled:
                self.obs.registry.gauge("kvswap_degradation_level").set(
                    self._degrade_level)
        elif ratio <= pol.recover_factor and self._degrade_level > 0:
            self._degrade_level -= 1
            if self._degrade_level < 2:
                self.engine.set_n_select(self._base_n_select)
            self._lat_window.clear()
            self._count("kvswap_degrade_transitions_total")
            if self.obs.enabled:
                self.obs.registry.gauge("kvswap_degradation_level").set(
                    self._degrade_level)

    # -- the scheduler iteration -----------------------------------------
    def step(self) -> list[dict]:
        """One continuous-batching iteration; returns this step's events.

        Admit → sample → retire → decode: every running slot samples one
        token from its current logits; slots that hit a stop token or their
        ``max_new`` budget retire *before* the decode step, so a finished
        request never burns another disk read (the static batcher's
        decode-to-batch-max waste).  Freed slots are refilled in the same
        iteration when due requests are waiting.  With an enabled obs
        handle the iteration is one ``serve.step`` wall span, its phases
        (``serve.admit``, ``serve.sample``, the engine's ``decode``,
        ``serve.logits_wait``) nested inside.
        """
        obs = self.obs
        if not obs.enabled:
            return self._step()
        t = obs.tracer.now_ns()
        at = {"step": len(self.engine.step_log)}
        try:
            return self._step()
        finally:
            obs.tracer.phase("serve.step", "step", t, at)

    def _step(self) -> list[dict]:
        events: list[dict] = []
        if not self._active() and self._waiting:
            # idle engine: jump the clock to the next arrival
            self.now = max(self.now, min(r.arrival for r in self._waiting))
            if self.obs.enabled:
                # the modeled-clock cursor must follow the jump, or the
                # next admission's span would overlap the idle gap
                self.obs.sync_model(self.now)
        self._admit_due(events)
        if not self._active():
            return events
        on = self.obs.enabled
        if on:
            tr = self.obs.tracer
            t = tr.now_ns()
        toks = np.zeros(self.n_slots, dtype=np.int64)
        for i in self._active():
            slot = self._slots[i]
            tok = int(np.asarray(slot.sampler(slot.logits)).reshape(-1)[0])
            slot.out.append(tok)
            if len(slot.out) == 1:
                slot.req.first_token_at = self.now
                if on:
                    slot.req.first_token_wall = tr.now_ns()
            events.append({"type": "token", "rid": slot.req.rid, "slot": i,
                           "token": tok})
            if tok in slot.stop_set:
                slot.req.stopped_early = True
                self._finish(i, events)
            elif len(slot.out) >= slot.req.max_new:
                self._finish(i, events)
            else:
                toks[i] = tok
        # slots freed above are refilled at the NEXT step's admission phase:
        # a request admitted now would join this decode step without having
        # sampled its first token (its logits come from the admission
        # prefill, which the sampling loop above has already passed)
        active = self._active()
        if on:
            at = {"step": len(self.engine.step_log)}
            tr.phase("serve.sample", "sample", t, at)
        if active:
            try:
                logits = self.engine.decode_step(toks)
                if on:
                    t = tr.now_ns()
                logits = logits.cpu().numpy()
                if on:
                    tr.phase("serve.logits_wait", "logits_wait", t, at)
            except StorageFault as exc:
                # unrecoverable mid-step fault: fail the culprit request,
                # replay the rest (docs/robustness.md rung 2) — the session
                # itself never crashes
                self._recover_from_decode_fault(exc, events)
                return events
            self.now += self.engine.step_log[-1].pipelined_seconds
            self._note_step_latency(self.engine.step_log[-1].pipelined_seconds)
            for i in active:
                self._slots[i].logits = logits[i:i + 1]
        return events

    def stream(self) -> Iterator[dict]:
        """Iterate scheduler steps until the session is idle, yielding
        admit/token/finish events as they happen."""
        while self._waiting or self._active():
            yield from self.step()

    def drain(self) -> dict[int, Request]:
        """Run to completion; returns every completed request by id
        (requests that failed terminally are in :attr:`failed`)."""
        for _ in self.stream():
            pass
        if self.prefix_cache is not None:
            self._save_cache()
        return self.completed

    def _save_cache(self) -> None:
        """Persist the prefix-cache manifest, absorbing storage faults: the
        manifest is an optimization for the *next* process, so a failed (or
        crash-injected) save must not fail a drain whose tokens are already
        complete.  A torn write is recovered at next open (empty index +
        orphan GC, see ``cache/manifest.py``)."""
        try:
            self.prefix_cache.save()
        except StorageFault:
            self.save_failures += 1
            self._count("kvswap_manifest_save_failures_total")

    def result(self, rid: int) -> np.ndarray:
        return self.completed[rid].output

    # -- accounting -------------------------------------------------------
    def per_request(self) -> list[dict]:
        """Per-request lifecycle breakdown (queue wait, TTFT, TPOT, end-to-
        end) for every completed request, ordered by rid — the aggregation
        path :mod:`repro_torch.serving.metrics` and the trace harness share."""
        from repro_torch.serving import metrics
        return metrics.per_request_breakdown(self.completed.values())

    def stats(self) -> dict:
        """Session-cumulative serving stats (goodput = completed-request
        tokens per modeled second — the benchmark's headline metric)."""
        done = list(self.completed.values())
        tokens = sum(len(r.output) for r in done)
        prompt_tokens = sum(len(r.prompt) for r in done)
        cached_prompt = sum(r.cached_tokens for r in done)
        eng = self.engine
        snap = eng.accountant.snapshot()
        served = snap["warm_bytes"] + snap["read_bytes"]
        # overlap_report's "warm_bytes" is the MEAN PER STEP; the session
        # also reports the accountant's session total under the same name.
        # Rename the per-step view so the two never shadow each other:
        #   warm_bytes          — session-cumulative warm-served bytes
        #   warm_bytes_per_step — mean warm-served bytes per decode step
        rep = eng.overlap_report()
        if "warm_bytes" in rep:
            rep["warm_bytes_per_step"] = rep.pop("warm_bytes")
        return {
            "completed_requests": len(done),
            "completed_tokens": tokens,
            "stopped_early": sum(r.stopped_early for r in done),
            # robustness accounting (docs/robustness.md): every request the
            # session refused or lost to storage faults, and what recovery
            # cost — FAILED + rejected + completed must equal submissions
            "failed_requests": len(self.failed),
            "rejected_requests": self.rejected,
            "recovered_rows": self.recovered_rows,
            "publish_failures": self.publish_failures,
            "save_failures": self.save_failures,
            "io_retries": sum(m.retries for m in eng.managers),
            "fetch_failures": sum(m.fetch_failures for m in eng.managers),
            "stall_seconds": snap.get("stall_seconds", 0.0),
            "degradation_level": self._degrade_level,
            "modeled_seconds": self.now,
            "goodput_tokens_per_s": tokens / self.now if self.now else 0.0,
            "waiting": len(self._waiting),
            "running": len(self._active()),
            "reuse_ratio": eng.reuse_ratio(),
            "read_bytes": snap["read_bytes"],
            "decode_steps": len(eng.step_log),
            **rep,
            # warm tier (repro.tiers): session-cumulative bytes served from
            # host RAM instead of disk, and their share of all fetch-served
            # bytes — both straight from the accountant's per-source
            # breakdown (same disk-read units), no reach into tier internals
            "warm_bytes": snap["warm_bytes"],
            "warm_hit_rate": snap["warm_bytes"] / served if served else 0.0,
            # prefix cache (completed requests only, same population as the
            # token counts above): share of prompt tokens restored from the
            # cache instead of prefilled — the affinity router's headline
            "prompt_tokens": prompt_tokens,
            "cached_prompt_tokens": cached_prompt,
            "prefix_hit_rate": (cached_prompt / prompt_tokens
                                if prompt_tokens else 0.0),
        }

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self.prefix_cache is not None and self.published_blocks:
            self._save_cache()   # publishes defer their manifest write
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
