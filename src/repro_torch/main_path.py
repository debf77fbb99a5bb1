"""The port's main paths, end to end: a serving session answering requests,
and a hybrid model generating through the engine.

:func:`run_main_path` builds a model from a config (random weights from a
seeded ``torch.Generator``), fits the low-rank adapter from layer 0's K on
one calibration prompt, and drains a :class:`~repro_torch.serving.ServeSession`
of greedy requests with seeded prompts through ``KVSwapEngine``.  It
returns what a caller checks and reports: the outputs, the decode steps,
each kernel's launches during the drain, per-step wall times and the time
each step sat waiting on group reads, throughput and peak device memory.
``chip_smoke.py`` runs it on the card at Llama-3.1-8B width; the CPU tests
run it at a tiny size.

:func:`run_hybrid_path` does the same for a hybrid of Mamba2 and shared
attention blocks (Zamba2), which ``ServeSession`` refuses: a batch of
seeded prompts through ``KVSwapEngine.generate``, whose prefill runs every
Mamba2 layer's chunked SSD (kernel C) and whose decode runs kernels A and B
on the attention layers only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.lowrank import fit_adapter
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.serving import ServeSession

KERNELS = (ops.lowrank_group_scores, ops.gather_attention)
HYBRID_KERNELS = (ops.lowrank_group_scores, ops.gather_attention, ops.ssd_chunk)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model_and_adapter(cfg: ModelConfig, calib: np.ndarray, *, rank: int, seed: int,
                       dev: torch.device):
    """Random weights from ``seed``, and the low-rank adapter fitted offline
    from the first KV layer's K on the prompt ``calib`` (after the state
    blocks before that layer)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, generator=gen, device=dev)
    model = TransformerAdapter(cfg)
    first_kv = model.layer_kinds.index("kv")
    tok = torch.as_tensor(calib[None], device=dev)
    pos = torch.arange(tok.shape[1], device=dev)[None]
    x = model.embed(params, tok)
    for layer in range(first_kv):
        x, _ = model.prefill_state_block(params, layer, x, pos)
    _, k0, _ = model.prefill_block(params, first_kv, x, pos)
    return model, params, fit_adapter(k0[0].cpu().numpy(), rank=rank, device=dev)


@contextlib.contextmanager
def _watched(engine: KVSwapEngine, dev: torch.device, *names: str):
    """Wrap the engine's methods ``names``: each call's wall time (to the
    device's end) goes to ``rec[name]``, and ``rec["finite"]`` stays true
    while every call's logits are finite.  The wrappers hold the engine's
    bound methods, so they are deleted on exit: otherwise the engine (and
    the model's weights) would wait in a reference cycle for the garbage
    collector after the engine closes."""
    rec: dict = {"finite": True, **{name: [] for name in names}}

    def wrap(name, fn):
        def call(arg):
            t0 = time.perf_counter()
            logits = fn(arg)
            _sync(dev)
            rec[name].append(time.perf_counter() - t0)
            rec["finite"] = rec["finite"] and bool(torch.isfinite(logits).all())
            return logits
        return call

    for name in names:
        setattr(engine, name, wrap(name, getattr(engine, name)))
    try:
        yield rec
    finally:
        for name in names:
            delattr(engine, name)


@contextlib.contextmanager
def _counted(kernels, dev: torch.device):
    """Peak device memory and each kernel's launches, both counted from
    entry; the launch counts fill the yielded dict on exit."""
    counts: dict = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    _sync(dev)
    yield counts
    counts.update({k.__name__: k.launches for k in kernels})


def _peak(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _profiled_prefill(engine: KVSwapEngine, prompts: np.ndarray, dev: torch.device) -> dict:
    """One more ``engine.prefill(prompts)`` under ``torch.profiler``: the
    window's host wall time, the device operations as ``(name, ms, calls)``
    from the largest total down (``ops``), the time the device was busy (the
    union of its operations' intervals) and the rest of the window, when
    the device did nothing and the host worked alone.  Without a card the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.prefill(prompts)
        _sync(dev)
        window = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end          # microseconds
        rec = by_name.setdefault(ev.name, [0.0, 0])
        rec[0] += end - start
        rec[1] += 1
        spans.append((start, end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy / 1e3
    return {"window_ms": window * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (window * 1e3),
            "host_only_ms": window * 1e3 - busy_ms,
            "ops": sorted(((name, us / 1e3, n) for name, (us, n) in by_name.items()),
                          key=lambda r: -r[1])}


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
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    calib = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
               for _ in range(n_requests)]
    model, params, adapter = _model_and_adapter(cfg, calib, rank=ecfg.rank, seed=seed, dev=dev)

    step_wall: list[float] = []
    with ServeSession(model, params, ecfg, slots=slots, adapter=adapter,
                      device=dev) as sess, _watched(sess.engine, dev, "decode_step") as rec:
        rids = [sess.submit(p, max_new) for p in prompts]
        with _counted(KERNELS, dev) as launches:
            t_start = time.perf_counter()
            while sess.has_work:
                t0 = time.perf_counter()
                events = sess.step()
                _sync(dev)
                if not any(e["type"] == "admit" for e in events):
                    step_wall.append(time.perf_counter() - t0)
            wall = time.perf_counter() - t_start
        outputs = [np.asarray(sess.completed[r].output) for r in rids]
        io_wait = [s.io_wait_seconds for s in sess.engine.step_log]
        stats = sess.stats()
    return {
        "outputs": outputs,
        "prompt_lens": [len(p) for p in prompts],
        "decode_steps": len(io_wait),
        "n_layers": cfg.n_layers,
        "launches": launches,
        "logits_finite": rec["finite"],
        "wall_seconds": wall,
        "tokens_per_s": sum(len(o) for o in outputs) / wall,
        "decode_step_wall_seconds": step_wall,
        "decode_step_io_wait_seconds": io_wait,
        "peak_memory_bytes": _peak(dev),
        "session_clock": stats["modeled_seconds"],
    }


def run_hybrid_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                    engine_cfg: EngineConfig | None = None, batch: int = 4,
                    prompt_len: int = 2048, max_new: int = 32, seed: int = 0,
                    profile_prefill: bool = False) -> dict:
    """Generate ``max_new`` greedy tokens for ``batch`` seeded prompts of
    ``prompt_len`` tokens through ``KVSwapEngine.generate``.

    ``n_layers`` keeps the first blocks of the pattern (widths stay the
    config's).  The adapter is fitted from the first KV layer's K on one
    calibration prompt, after the blocks before that layer.  Every
    kernel's launch count is set to 0 just before ``generate`` and read
    just after.  ``profile_prefill`` then prefills the same prompts once
    more under ``torch.profiler`` (``prefill_profile`` in the result: see
    :func:`_profiled_prefill`); the counts and times above exclude it.
    """
    dev = resolve(device)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, block_pattern=cfg.blocks[:n_layers])
    ecfg = engine_cfg or EngineConfig()
    rng = np.random.default_rng(seed)
    calib = rng.integers(0, cfg.vocab_size, prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    model, params, adapter = _model_and_adapter(cfg, calib, rank=ecfg.rank, seed=seed, dev=dev)

    with KVSwapEngine(model, params, ecfg, batch=batch, adapter=adapter, device=dev) as engine, \
            _watched(engine, dev, "prefill", "decode_step") as rec:
        with _counted(HYBRID_KERNELS, dev) as launches:
            t_start = time.perf_counter()
            tokens = engine.generate(prompts, max_new)
            wall = time.perf_counter() - t_start
        io_wait = [s.io_wait_seconds for s in engine.step_log]
        n_store_layers = engine.store.n_layers
        n_states = len(engine.states)
        peak = _peak(dev)
        profiled = _profiled_prefill(engine, prompts, dev) if profile_prefill else None
    return {
        "tokens": tokens,
        "n_layers": cfg.n_layers,
        "n_kv_layers": len(cfg.kv_layers),
        "n_store_layers": n_store_layers,
        "n_states": n_states,
        "decode_steps": len(io_wait),
        "launches": launches,
        "logits_finite": rec["finite"],
        "wall_seconds": wall,
        "tokens_per_s": tokens.size / wall,
        "prefill_seconds": rec["prefill"][0],
        "decode_step_wall_seconds": rec["decode_step"],
        "decode_step_io_wait_seconds": io_wait,
        "peak_memory_bytes": peak,
        "prefill_profile": profiled,
    }
