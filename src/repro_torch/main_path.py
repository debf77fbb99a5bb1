"""The port's main paths, end to end: a serving session answering requests,
the same session over a shared prompt prefix through the prefix cache, and
a hybrid model generating through the engine.

:func:`run_main_path` builds a model from a config (random weights from a
seeded ``torch.Generator``), fits the low-rank adapter from layer 0's K on
one calibration prompt, and drains a :class:`~repro_torch.serving.ServeSession`
of greedy requests with seeded prompts through ``KVSwapEngine``.  It
returns what a caller checks and reports: the outputs, the decode steps,
each kernel's launches during the drain, per-step wall times and the time
each step sat waiting on group reads, throughput and peak device memory.
``chip_smoke.py`` runs it on the card at Llama-3.1-8B width; the CPU tests
run it at a tiny size.

:func:`run_prefix_path` serves requests whose prompts share one long
prefix through ``ServeSession(prefix_cache=...)``: the first admissions
run cold and publish their KV at retirement, the later ones restore the
prefix and prefill only their own suffix.  A control session without the
cache serves the same requests on the same weights, and one prompt is
admitted warm and cold in two fresh engines to compare the logits' bits.
:func:`build_weights` builds the model once for both serving paths.

:func:`run_hybrid_path` does the same for a hybrid of Mamba2 and shared
attention blocks (Zamba2), which ``ServeSession`` refuses: a batch of
seeded prompts through ``KVSwapEngine.generate``, whose prefill runs every
Mamba2 layer's chunked SSD (kernel C) and whose decode runs kernels A and B
on the attention layers only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import tempfile
import time

import numpy as np
import torch

from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.lowrank import fit_adapter
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L
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
    device's end) goes to ``rec[name]``, the accountant's charges made by the
    call's thread to ``rec["io"][name]`` (an ``IOTracker`` a call), and
    ``rec["finite"]`` stays true while every call's logits are finite.  The wrappers hold the engine's
    bound methods, so they are deleted on exit: otherwise the engine (and
    the model's weights) would wait in a reference cycle for the garbage
    collector after the engine closes."""
    rec: dict = {"finite": True, "io": {name: [] for name in names},
                 **{name: [] for name in names}}

    def wrap(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            with engine.accountant.track() as tr:
                out = fn(*args, **kwargs)
                _sync(dev)
            rec[name].append(time.perf_counter() - t0)
            rec["io"][name].append(tr)
            if torch.is_tensor(out):
                rec["finite"] = rec["finite"] and bool(torch.isfinite(out).all())
            return out
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


def _profiled(fn, dev: torch.device) -> dict:
    """One ``fn()`` call under ``torch.profiler``: the window's host wall
    time, the device operations as ``(name, ms, calls)`` from the largest
    total down (``ops``), the time the device was busy (the union of its
    operations' intervals) and the rest of the window, when the device did
    nothing and the host worked alone.  Without a card the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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


def _cut(cfg: ModelConfig, n_layers: int | None) -> ModelConfig:
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _main_calib(rng: np.random.Generator, cfg: ModelConfig, prompt_len) -> np.ndarray:
    lo, hi = prompt_len
    return rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))


def build_weights(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                  rank: int = 64, prompt_len: tuple[int, int] = (1024, 2048),
                  seed: int = 0) -> tuple:
    """``(model, params, adapter)`` exactly as :func:`run_main_path` builds
    them for the same arguments, to hand to it and to
    :func:`run_prefix_path` (``weights=``) so both serve one copy."""
    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    calib = _main_calib(np.random.default_rng(seed), cfg, prompt_len)
    return _model_and_adapter(cfg, calib, rank=rank, seed=seed, dev=dev)


def _serve(model, params, adapter, ecfg: EngineConfig, dev: torch.device, prompts,
           max_new: int, *, slots: int, prefix_cache=None, faults=None) -> dict:
    """Drain one session of greedy requests: outputs (``None`` for a
    request that failed), per-step walls without admissions, each admission's
    wall (to the device's end) with its cached and computed tokens, and the
    kernels' launches in the drain (peak device memory is counted from its
    start too)."""
    step_wall: list[float] = []
    with ServeSession(model, params, ecfg, slots=slots, adapter=adapter, device=dev,
                      prefix_cache=prefix_cache, faults=faults) as sess, \
            _watched(sess.engine, dev, "decode_step", "admit_row", "publish") as rec:
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
        outputs = [np.asarray(sess.completed[r].output) if r in sess.completed else None
                   for r in rids]
        eng = sess.engine
        admissions = [{"cached_tokens": rep["cached_tokens"],
                       "computed_tokens": rep["computed_tokens"], "wall_seconds": w,
                       "restore_bytes": tr.read_bytes}
                      for rep, w, tr in zip(eng.admit_log, rec["admit_row"],
                                            rec["io"]["admit_row"])]
        published = rec["io"]["publish"]
        return {
            "outputs": outputs,
            "decode_steps": len(eng.step_log),
            "launches": launches,
            "logits_finite": rec["finite"],
            "wall_seconds": wall,
            "tokens_per_s": sum(len(o) for o in outputs if o is not None) / wall,
            "decode_step_wall_seconds": step_wall,
            "decode_step_io_wait_seconds": [s.io_wait_seconds for s in eng.step_log],
            "admissions": admissions,
            "publish_read_bytes": sum(tr.read_bytes for tr in published),
            "publish_write_bytes": sum(tr.write_bytes for tr in published),
            "publish_seconds": sum(rec["publish"]),
            "accountant": eng.accountant.snapshot(),
            "stats": sess.stats(),
            "prefetch_deaths": eng.prefetcher.deaths if eng.prefetcher is not None else 0,
        }


def run_main_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                  engine_cfg: EngineConfig | None = None, slots: int = 4,
                  n_requests: int = 6, prompt_len: tuple[int, int] = (1024, 2048),
                  max_new: int = 32, seed: int = 0, weights: tuple | None = None,
                  faults=None) -> dict:
    """Serve ``n_requests`` greedy requests (prompt lengths drawn uniformly
    from ``prompt_len``, ``max_new`` tokens each) over ``slots`` slots.

    ``n_layers`` cuts the depth (widths stay the config's).  ``weights``
    from :func:`build_weights` (same ``cfg``, ``n_layers``, ``prompt_len``
    and ``seed``) skips building the model; ``faults`` (a ``FaultPlan``)
    goes to the session.  Every kernel's launch count is set to 0 just
    before the drain and read just after.  ``outputs`` holds ``None`` for a
    request that failed.
    """
    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    ecfg = engine_cfg or EngineConfig()
    rng = np.random.default_rng(seed)
    calib = _main_calib(rng, cfg, prompt_len)
    lo, hi = prompt_len
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
               for _ in range(n_requests)]
    model, params, adapter = weights or _model_and_adapter(cfg, calib, rank=ecfg.rank,
                                                           seed=seed, dev=dev)
    run = _serve(model, params, adapter, ecfg, dev, prompts, max_new, slots=slots,
                 faults=faults)
    return {**run, "prompt_lens": [len(p) for p in prompts], "n_layers": cfg.n_layers,
            "peak_memory_bytes": _peak(dev), "session_clock": run["stats"]["modeled_seconds"]}


def prefix_prompts(vocab_size: int, *, n_requests: int, prefix_len: int,
                   suffix_len: tuple[int, int], seed: int) -> list[np.ndarray]:
    """``n_requests`` prompts from numpy ``seed``: one shared prefix of
    ``prefix_len`` tokens, then each prompt's own suffix of a length drawn
    uniformly from ``suffix_len``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, prefix_len)
    lo, hi = suffix_len
    return [np.concatenate([prefix, rng.integers(0, vocab_size, int(rng.integers(lo, hi + 1)))])
            for _ in range(n_requests)]


def _layer_ops(model, params, layer: int, x: torch.Tensor, positions: torch.Tensor,
               k_pre: torch.Tensor | None) -> tuple[dict, torch.Tensor]:
    """Attention block ``layer`` op by op, as ``block_forward`` computes it
    (with ``k_pre = (K, V)`` of the rows before ``x``'s, as
    ``prefill_block_with_ctx`` does): its named intermediates in order, query
    rows on dim 1 (``"k"`` and ``"v"`` hold every row's K and V, prefix
    first; ``"scores"`` every key on the last dim), and the block's output."""
    cfg = model.cfg
    blk = params["blocks"][layer]
    attn_p = blk["attn"]
    out = {}
    h = out["attn_norm"] = L.rmsnorm(blk["attn_norm"], x)
    b, n, _ = h.shape
    for w in ("wq", "wk", "wv"):
        out[f"x @ {w}"] = h @ attn_p[w]
    q = L.apply_rope(out["x @ wq"].reshape(b, n, cfg.n_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
    k = L.apply_rope(out["x @ wk"].reshape(b, n, cfg.n_kv_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
    v = out["x @ wv"].reshape(b, n, cfg.n_kv_heads, cfg.head_dim)
    if k_pre is not None:
        k, v = torch.cat([k_pre[0], k], 1), torch.cat([k_pre[1], v], 1)
    out["k"], out["v"] = k, v
    rep = cfg.n_heads // cfg.n_kv_heads
    out["scores"] = torch.einsum("bqhd,bkhd->bqhk", q, L.repeat_kv(k, rep)) / math.sqrt(cfg.head_dim)
    o = out["attention"] = (L.causal_attention(q, k, v) if k_pre is None
                            else L.chunked_causal_attention(q, k, v, k.shape[1] - n))
    x = out["o @ wo"] = x + o.reshape(b, n, -1) @ attn_p["wo"]
    h2 = out["mlp_norm"] = L.rmsnorm(blk["mlp_norm"], x)
    out["x @ w_gate"] = h2 @ blk["mlp"]["w_gate"]
    out["x @ w_up"] = h2 @ blk["mlp"]["w_up"]
    x = out["block output"] = x + L.swiglu(blk["mlp"], h2)
    return out, x


def _first_divergence(model, params, dev: torch.device, a: tuple, b: tuple,
                      lo: int, hi: int) -> tuple[str | None, float]:
    """Walk two forwards through every layer op by op and name the first
    operation whose rows ``[lo, hi)`` (K and V: ``[0, hi)``) differ in their
    bits, with its largest absolute difference; ``(None, 0.0)`` if none does.

    ``a`` and ``b`` are ``(tokens, start, prefix)``: the forward runs rows
    ``[start, len(tokens))``, and ``prefix`` (with ``start > 0``) gives each
    layer's K and V of the rows before, ``[n_layers, start, H_kv, d]`` each
    (a restore from the cache)."""

    def forward(tokens, start, prefix):
        tok = torch.as_tensor(tokens[None, start:], device=dev)
        pos = torch.arange(start, len(tokens), device=dev)[None]
        x = model.embed(params, tok)
        for layer in range(model.n_layers):
            kv = None if prefix is None else tuple(
                torch.from_numpy(p[layer][None]).to(dev) for p in prefix)
            ops, x = _layer_ops(model, params, layer, x, pos, kv)
            yield {name: (t[:, :hi] if name in ("k", "v") else
                          t[:, lo - start:hi - start, ..., :hi] if name == "scores" else
                          t[:, lo - start:hi - start])
                   for name, t in ops.items()}

    for layer, (ops_a, ops_b) in enumerate(zip(forward(*a), forward(*b))):
        for name, ta in ops_a.items():
            tb = ops_b[name]
            if not torch.equal(ta, tb):
                return f"layer {layer}: {name}", float((ta - tb).abs().max())
    return None, 0.0


@contextlib.contextmanager
def _timing(*targets):
    """Host wall seconds spent in each ``(obj, name)`` method while inside,
    summed over its calls (no device sync: a call that downloads waits for
    the device work queued before it).  The wrappers are removed on exit."""
    spent: dict = {}

    def wrap(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return call

    for obj, name in targets:
        spent[name] = 0.0
        setattr(obj, name, wrap(name, getattr(obj, name)))
    try:
        yield spent
    finally:
        for obj, name in targets:
            delattr(obj, name)


def _warm_cold(model, params, adapter, ecfg: EngineConfig, dev: torch.device, cache,
               prompt: np.ndarray, slots: int, publisher: np.ndarray) -> tuple[dict, dict]:
    """Admit ``prompt`` at slot 0 of two fresh engines, cold and then warm
    from ``cache`` under ``torch.profiler``: the comparison of their
    last-position logits, and the warm admission's profile with its restore
    bytes and the host time in its parts (``host_ms``): the restore read
    (checksums and copy), the uploads of the restored K and V, the downloads
    of the computed K and V (each waits for its layer's device work), and
    the writes of the whole prompt's K and V to the engine's disk store.

    Where the logits differ, the comparison names the first operation whose
    bits differ between the cold forward and the warm one over the restored
    prefix, and the first one between the cold forwards of ``publisher``
    (the prompt whose admission wrote the cached prefix) and of ``prompt``
    on their shared rows (where the restored K and V come from)."""
    logits = {}
    with KVSwapEngine(model, params, ecfg, batch=slots, adapter=adapter, device=dev) as eng:
        logits["cold"] = eng.admit_row(0, prompt)
    with KVSwapEngine(model, params, ecfg, batch=slots, adapter=adapter, device=dev) as eng:
        with _timing((cache, "read_chain"), (eng, "_upload"), (eng, "_host"),
                     (eng.store, "write_prefill_row")) as spent, \
                eng.accountant.track() as tr:
            prof = _profiled(lambda: logits.__setitem__(
                "warm", eng.admit_row(0, prompt, cache)), dev)
        n, k_pre, v_pre = eng._restore_prefix(cache, prompt, len(prompt))
    out = {"cached_tokens": n, "bits_equal": bool(torch.equal(logits["warm"], logits["cold"])),
           "max_abs_diff": float((logits["warm"] - logits["cold"]).abs().max()),
           "max_abs_logit": float(logits["cold"].abs().max()),
           "first_divergence": None, "first_divergence_diff": 0.0,
           "prefix_divergence": None, "prefix_divergence_diff": 0.0}
    if not out["bits_equal"] and n:
        out["first_divergence"], out["first_divergence_diff"] = _first_divergence(
            model, params, dev, (prompt, 0, None), (prompt, n, (k_pre, v_pre)), n, len(prompt))
        out["prefix_divergence"], out["prefix_divergence_diff"] = _first_divergence(
            model, params, dev, (publisher, 0, None), (prompt, 0, None), 0, n)
    return out, {**prof, "restore_bytes": tr.read_bytes,
                 "host_ms": {name: sec * 1e3 for name, sec in spent.items()}}


def run_prefix_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                    engine_cfg: EngineConfig | None = None, weights: tuple | None = None,
                    slots: int = 4, n_requests: int = 8, prefix_len: int = 1536,
                    suffix_len: tuple[int, int] = (256, 512), max_new: int = 32,
                    cache_cfg: PrefixCacheConfig | None = None, cache_faults=None,
                    compare: bool = True, seed: int = 0) -> dict:
    """Serve ``n_requests`` greedy requests sharing one ``prefix_len``-token
    prefix (:func:`prefix_prompts`) through ``ServeSession(prefix_cache=...)``
    over ``slots`` slots, then the same requests in a control session without
    the cache, on the same weights (``weights`` from :func:`build_weights`,
    else built here as :func:`run_main_path` builds them).

    The first ``slots`` admissions find the cache empty, run cold and publish
    at retirement; the later ones restore the prefix.  Every kernel's launch
    count is set to 0 just before the cache session's drain and read just
    after.  The cache lives in a temporary directory removed at the end;
    ``cache_faults`` (a ``FaultPlan``) is injected into it.  ``compare``
    admits one more prompt of the same kind, which no session served, cold
    and warm in two fresh engines (:func:`_warm_cold`: ``warm_cold`` and
    ``warm_profile`` in the result).
    """
    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    ecfg = engine_cfg or EngineConfig()
    model, params, adapter = weights or build_weights(cfg, device=dev, rank=ecfg.rank,
                                                      seed=seed)
    *prompts, fresh = prefix_prompts(cfg.vocab_size, n_requests=n_requests + 1,
                                     prefix_len=prefix_len, suffix_len=suffix_len, seed=seed)
    ccfg = cache_cfg or PrefixCacheConfig(block_tokens=32, budget_bytes=2 << 30)
    with tempfile.TemporaryDirectory(prefix="prefix-cache-") as tmp, \
            PrefixCache(dataclasses.replace(ccfg, dir=tmp)) as cache:
        if cache_faults is not None:
            cache.use_faults(cache_faults)
        run = _serve(model, params, adapter, ecfg, dev, prompts, max_new, slots=slots,
                     prefix_cache=cache)
        run["peak_memory_bytes"] = _peak(dev)
        run["cache_stats"] = dataclasses.asdict(cache.stats)
        run["resident_blocks"] = cache.resident_blocks()
        if compare:
            run["warm_cold"], run["warm_profile"] = _warm_cold(
                model, params, adapter, ecfg, dev, cache, fresh, slots, prompts[0])
    control = _serve(model, params, adapter, ecfg, dev, prompts, max_new, slots=slots)
    run.update({
        "n_layers": cfg.n_layers,
        "prompt_lens": [len(p) for p in prompts],
        "control_outputs": control["outputs"],
        "tokens_equal": [a is not None and b is not None and np.array_equal(a, b)
                         for a, b in zip(run["outputs"], control["outputs"])],
        "control_admissions": control["admissions"],
    })
    return run


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
    :func:`_profiled`); the counts and times above exclude it.
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
        profiled = (_profiled(lambda: engine.prefill(prompts), dev)
                    if profile_prefill else None)
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
