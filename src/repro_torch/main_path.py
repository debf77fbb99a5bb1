"""The port's main path, end to end: a serving session answering requests.

:func:`run_main_path` builds a model from a config (random weights from a
seeded ``torch.Generator``), fits the low-rank adapter from layer 0's K on
one calibration prompt, and drains a :class:`~repro_torch.serving.ServeSession`
of greedy requests with seeded prompts through ``KVSwapEngine``.  It
returns what a caller checks and reports: the outputs, the decode steps,
each kernel's launches during the drain, per-step wall times and the time
each step sat waiting on group reads, throughput and peak device memory.  ``chip_smoke.py`` runs it on the card at
Llama-3.1-8B width; the CPU tests run it at a tiny size.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.core.lowrank import fit_adapter
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.serving import ServeSession

KERNELS = (ops.lowrank_group_scores, ops.gather_attention)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_main_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                  engine_cfg: EngineConfig | None = None, slots: int = 4,
                  n_requests: int = 6, prompt_len: tuple[int, int] = (1024, 2048),
                  max_new: int = 32, seed: int = 0) -> dict:
    """Serve ``n_requests`` greedy requests (prompt lengths drawn uniformly
    from ``prompt_len``, ``max_new`` tokens each) over ``slots`` slots.

    ``n_layers`` cuts the depth (widths stay the config's).  Every kernel's
    launch count is set to 0 just before the drain and read just after.
    """
    dev = resolve(device)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ecfg = engine_cfg or EngineConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, generator=gen, device=dev)
    model = TransformerAdapter(cfg)
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    calib = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
               for _ in range(n_requests)]

    # the adapter: layer 0's K on one calibration prompt, fitted offline
    tok = torch.as_tensor(calib[None], device=dev)
    pos = torch.arange(tok.shape[1], device=dev)[None]
    _, k0, _ = model.prefill_block(params, 0, model.embed(params, tok), pos)
    adapter = fit_adapter(k0[0].cpu().numpy(), rank=ecfg.rank, device=dev)
    del k0

    finite = True
    step_wall: list[float] = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with ServeSession(model, params, ecfg, slots=slots, adapter=adapter,
                      device=dev) as sess:
        engine = sess.engine
        decode = engine.decode_step

        def checked_decode(tokens):
            nonlocal finite
            logits = decode(tokens)
            finite = finite and bool(torch.isfinite(logits).all())
            return logits

        engine.decode_step = checked_decode
        rids = [sess.submit(p, max_new) for p in prompts]
        for kernel in KERNELS:
            kernel.launches = 0
        _sync(dev)
        t_start = time.perf_counter()
        while sess.has_work:
            t0 = time.perf_counter()
            events = sess.step()
            _sync(dev)
            if not any(e["type"] == "admit" for e in events):
                step_wall.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_start
        launches = {k.__name__: k.launches for k in KERNELS}
        done = sess.completed
        outputs = [np.asarray(done[r].output) for r in rids]
        n_steps = len(engine.step_log)
        io_wait = [s.io_wait_seconds for s in engine.step_log]
        stats = sess.stats()
    return {
        "outputs": outputs,
        "prompt_lens": [len(p) for p in prompts],
        "decode_steps": n_steps,
        "n_layers": cfg.n_layers,
        "launches": launches,
        "logits_finite": finite,
        "wall_seconds": wall,
        "tokens_per_s": sum(len(o) for o in outputs) / wall,
        "decode_step_wall_seconds": step_wall,
        "decode_step_io_wait_seconds": io_wait,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "session_clock": stats["modeled_seconds"],
    }
