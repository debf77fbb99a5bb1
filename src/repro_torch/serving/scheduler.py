"""Static-batch compatibility front end over the continuous serving API.

The PyTorch port of :mod:`repro.serving.scheduler`.  Differences from the
reference: ``BatchServer`` takes ``device=`` (``None`` = the CUDA card)
and ``adapter=`` (a fitted low-rank adapter, instead of ``calib_k``) and
passes both through to its :class:`ServeSession`; ``calib_k`` is optional
when ``adapter`` is given.  The rest is the reference's code.

Historically this module owned the static batcher: ``flush()`` constructed a
fresh engine per batch, padded short batches with clone rows (burning real
disk reads) and decoded every request to the batch-max ``max_new`` before
truncating.  The serving API redesign moved the real machinery into
:class:`repro_torch.serving.api.ServeSession` — a **persistent** engine with
per-slot admission/retirement — and :class:`BatchServer` survives as a thin
wrapper that keeps the old surface (``submit``/``flush``/``result``/
``last_stats``) for existing callers, benchmarks and examples:

* one engine lives across flushes (jit caches, reuse buffers and the prefix
  cache all stay warm),
* short batches admit only **real** rows — empty slots are masked, issue no
  disk reads, and ``last_stats["padded_requests"]`` counts them with zero
  IO charged (no more clone-row waste),
* each request decodes exactly to its own ``max_new`` / stop token; nobody
  rides to the batch max.

``last_stats`` keeps its historical keys (throughput, overlap, prefill and
prefix-cache sections), computed over the flush's window of the persistent
engine's step log.

New code should use :class:`~repro_torch.serving.api.ServeSession` directly —
see ``docs/architecture.md`` ("Serving API").
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.cache import PrefixCache
from repro_torch.core.engine import EngineConfig, summarize_steps
from repro_torch.serving.api import Request, ServeSession
from repro_torch.serving.sampling import greedy

__all__ = ["BatchServer", "Request", "greedy_sampler"]

# the one sampling entry point (repro_torch.serving.sampling); kept under the old
# name for callers that imported it from here
greedy_sampler = greedy


def _aggregate_admissions(reports: list[dict]) -> dict:
    """Sum the per-admission prefill reports of one flush window."""
    keys = ("prompt_tokens", "cached_tokens", "computed_tokens",
            "restore_seconds", "write_seconds", "compute_seconds",
            "modeled_seconds", "modeled_cold_seconds", "wall_seconds")
    return {k: sum(r[k] for r in reports) for k in keys}


class BatchServer:
    """Static batcher facade: collects ``batch`` requests, serves them
    together through a persistent :class:`ServeSession`."""

    def __init__(self, model_adapter, params, engine_cfg: EngineConfig, *,
                 batch: int, calib_k: np.ndarray | None = None,
                 sampler: Callable | None = None,
                 prefix_cache: PrefixCache | None = None,
                 adapter=None, device=None):
        self.cfg = engine_cfg
        self.batch = batch
        # legacy samplers take a whole logits block; the session applies
        # them per row ([1, V] slices), which every historical sampler
        # (greedy, make_sampler) already handled
        self.sampler = sampler
        self.prefix_cache = prefix_cache
        self.session = ServeSession(model_adapter, params, engine_cfg,
                                    slots=batch, calib_k=calib_k,
                                    adapter=adapter,
                                    prefix_cache=prefix_cache,
                                    device=device)
        self._queue: list[tuple[int, np.ndarray, int]] = []
        self._rid_map: dict[int, int] = {}   # public rid -> session rid
        self._next_id = 0
        self.completed: dict[int, Request] = {}
        self.last_stats: dict = {}

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(prompt, np.int64), max_new))
        if len(self._queue) >= self.batch:
            self.flush()
        return rid

    def flush(self) -> None:
        """Serve everything queued (up to ``batch``); empty slots stay
        masked instead of decoding clone rows."""
        if not self._queue:
            return
        todo, self._queue = self._queue[: self.batch], self._queue[self.batch:]
        real = len(todo)
        eng = self.session.engine
        step_mark = len(eng.step_log)
        admit_mark = len(eng.admit_log)
        pub_mark = self.session.published_blocks
        for rid, prompt, max_new in todo:
            self._rid_map[rid] = self.session.submit(
                prompt, max_new, sampler=self.sampler)
        results = self.session.drain()
        for rid, _, _ in todo:
            req = results[self._rid_map[rid]]
            self.completed[rid] = req

        window = eng.step_log[step_mark:]
        rep = _aggregate_admissions(eng.admit_log[admit_mark:])
        steady = window[1:] or window
        mean_t = (sum(s.pipelined_seconds for s in steady) / len(steady)
                  if steady else 0.0)
        rate = 1.0 / mean_t if mean_t > 0 else 0.0   # per-slot tokens/s
        # a flush of max_new=1 requests runs zero decode steps (the single
        # token comes from the admission logits); keep the overlap keys
        # present with zeros so consumers never KeyError
        overlap = summarize_steps(steady) or {
            k: 0.0 for k in ("io_seconds", "compute_seconds",
                             "pipelined_seconds", "overlap_saved_seconds",
                             "wall_seconds", "io_wait_seconds", "h2d_bytes",
                             "active_rows")}
        stats = {
            "reuse_ratio": eng.reuse_ratio(),
            "throughput": real * rate,
            "batch_throughput": self.batch * rate,
            "real_requests": real,
            # empty slots are masked rows: zero groups selected, zero disk
            # reads, zero modeled time — not clone decodes
            "padded_requests": self.batch - real,
            "async_io": self.cfg.async_io,
            "prefill": rep,
            **overlap,
        }
        if self.prefix_cache is not None:
            stats["prefix_cache"] = {
                "hit_rate": rep["cached_tokens"] / max(rep["prompt_tokens"], 1),
                "saved_prefill_tokens": rep["cached_tokens"],
                "published_blocks": self.session.published_blocks - pub_mark,
                "resident_blocks": self.prefix_cache.resident_blocks(),
                "resident_bytes": self.prefix_cache.resident_bytes(),
                "session_hit_rate": self.prefix_cache.stats.hit_rate,
                "modeled_prefill_speedup": (
                    rep["modeled_cold_seconds"] / rep["modeled_seconds"]
                    if rep["modeled_seconds"] else 1.0),
            }
        self.last_stats = stats

    def result(self, rid: int) -> np.ndarray:
        return np.asarray(self.completed[rid].output, np.int32)

    def close(self) -> None:
        self.session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
