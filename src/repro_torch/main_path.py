"""The port's main paths, end to end: a serving session answering requests,
the same session over a shared prompt prefix through the prefix cache, the
serving front half (replicas behind the KV-affinity router, and a prefill
engine handing off to a decode session), and a hybrid model generating
through the engine.

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

:func:`run_router_path` replays a multi-tenant chat trace through
``FrontEnd(pool, PrefixAffinityRouter())`` over replicas with their own
prefix caches; :func:`run_disagg_path` serves long prompts through
``DisaggFrontEnd`` (a ``PrefillEngine`` publishing into a shared cache, a
decode session restoring from it) and again in a co-located control
session.  :func:`compare_routes` runs one tiny engine on the card and on
the CPU and compares every group selection and token.

:func:`run_hybrid_path` serves a hybrid of Mamba2 and shared attention
blocks (Zamba2), which ``ServeSession`` refuses: a batch of
seeded prompts through ``KVSwapEngine.generate``, whose prefill runs every
Mamba2 layer's chunked SSD (kernel C) and whose decode runs kernels A and B
on the attention layers only.

:func:`tuned_engine_config` runs the paper's offline tuner for a config and
turns its tuple into an ``EngineConfig``; ``run_main_path(probe=...)``
captures one decode step's true query and full K and V at one layer, with
the engine's own selection there, and :func:`probe_fidelity` scores the
paper's baselines and the engine's selection on them.  Any config the
registry builds, dense or MoE, serves through :func:`run_main_path`.

:func:`run_device_path` serves a batch through the full-cache device path
(``serving/decode.py``: ``prefill`` then ``serve_step``, in ``full`` or
``kvswap`` mode, with the rolling buffer if asked), for any config the
registry builds, the attention-free xLSTM and Whisper included;
:func:`run_whisper_path` runs Whisper's encoder output through
``KVSwapEngine.generate`` (the engine's host-gather route), on weights
from :func:`whisper_weights`.
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
from repro_torch.core import hardware, tuner
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.lowrank import fit_adapter
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.serving import SLOClass, ServeSession, Trace, mixed_tenant_trace
from repro_torch.serving import decode as D

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
def _watched(engine: KVSwapEngine, dev: torch.device, *names: str, keep: tuple = ()):
    """Wrap the engine's methods ``names``: each call's wall time (to the
    device's end) goes to ``rec[name]``, the accountant's charges made by the
    call's thread to ``rec["io"][name]`` (an ``IOTracker`` a call), and
    ``rec["finite"]`` stays true while every call's logits are finite; the
    outputs of the methods in ``keep`` are copied to the host into
    ``rec["out"][name]``.  The wrappers hold the engine's
    bound methods, so they are deleted on exit: otherwise the engine (and
    the model's weights) would wait in a reference cycle for the garbage
    collector after the engine closes."""
    rec: dict = {"finite": True, "io": {name: [] for name in names},
                 "out": {name: [] for name in keep}, **{name: [] for name in names}}

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
                if name in keep:
                    rec["out"][name].append(out.detach().cpu())
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


@contextlib.contextmanager
def _probed(engine: KVSwapEngine, probe: tuple[int, int] | None, dev: torch.device):
    """With ``probe = (step, layer)``: as the engine's decode step ``step``
    (counted from 0) enters model layer ``layer``'s attention, take to the
    host the true query (the layer's input through its norm, Q projection,
    qk-norm and RoPE: the query the attention uses) ``q [B, H, d]``, the
    engine's own selection for that layer (``ids``, ``mask``: ``[B, M]``,
    inactive rows masked) and, for each active row, its K and V before this
    token (``k``, ``v``: the full context) and the K on disk (``k_disk``:
    the tokens ``k_lr`` covers); ``seconds`` is the capture's wall, which
    the step's wall holds.  The hook is removed on exit."""
    rec: dict = {}
    if probe is None:
        yield rec
        return
    step, layer = probe

    def hook(lyr, x, positions, table):
        if lyr != layer or len(engine.step_log) != step or "q" in rec:
            return
        t0 = time.perf_counter()
        q = engine.model.predict_query(engine.params, lyr, x, positions)
        rows = np.flatnonzero(engine.row_active)           # this step's rows
        rec.update(step=step, layer=layer, q=q.float().cpu().numpy(), rows=rows,
                   ids=table.group_ids.copy(), mask=table.group_mask.copy(),
                   k_disk={}, k={}, v={})
        for bi in rows:
            k, v, n_disk = engine.layer_context(lyr, int(bi))
            rec["k"][int(bi)], rec["v"][int(bi)], rec["k_disk"][int(bi)] = k, v, k[:n_disk]
        _sync(dev)
        rec["seconds"] = time.perf_counter() - t0

    engine.layer_hook = hook
    try:
        yield rec
    finally:
        engine.layer_hook = None


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


def main_prompts(cfg: ModelConfig, *, n_requests: int = 6,
                 prompt_len: tuple[int, int] = (1024, 2048),
                 seed: int = 0) -> tuple[np.ndarray, list[np.ndarray]]:
    """:func:`run_main_path`'s calibration prompt and its ``n_requests``
    request prompts for the same arguments, each of a length drawn
    uniformly from ``prompt_len``: a caller can know the run's shapes
    before it runs."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    calib, *prompts = (rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
                       for _ in range(1 + n_requests))
    return calib, prompts


def build_weights(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                  rank: int = 64, prompt_len: tuple[int, int] = (1024, 2048),
                  seed: int = 0) -> tuple:
    """``(model, params, adapter)`` exactly as :func:`run_main_path` builds
    them for the same arguments, to hand to it and to
    :func:`run_prefix_path` (``weights=``) so both serve one copy."""
    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    calib, _ = main_prompts(cfg, n_requests=0, prompt_len=prompt_len, seed=seed)
    return _model_and_adapter(cfg, calib, rank=rank, seed=seed, dev=dev)


def _serve(model, params, adapter, ecfg: EngineConfig, dev: torch.device, prompts,
           max_new: int, *, slots: int, prefix_cache=None, faults=None,
           keep_logits: bool = False, probe: tuple[int, int] | None = None) -> dict:
    """Drain one session of greedy requests: outputs (``None`` for a
    request that failed), per-step walls without admissions, each admission's
    wall (to the device's end) with its cached and computed tokens, and the
    kernels' launches in the drain (peak device memory is counted from its
    start too); ``keep_logits`` also returns each admission's logits on the
    host, in admission order (``admission_logits``); ``probe = (step,
    layer)`` returns :func:`_probed`'s capture (``probe``), whose step is
    left out of the step walls and whose capture time is taken off the
    drain's wall."""
    step_wall: list[float] = []
    with ServeSession(model, params, ecfg, slots=slots, adapter=adapter, device=dev,
                      prefix_cache=prefix_cache, faults=faults) as sess, \
            _watched(sess.engine, dev, "decode_step", "admit_row", "publish",
                     keep=("admit_row",) if keep_logits else ()) as rec, \
            _probed(sess.engine, probe, dev) as probed:
        rids = [sess.submit(p, max_new) for p in prompts]
        with _counted(KERNELS, dev) as launches:
            t_start = time.perf_counter()
            while sess.has_work:
                t0 = time.perf_counter()
                was_probed = "q" in probed
                events = sess.step()
                _sync(dev)
                # the probed step's wall holds the capture: it is left out
                if not any(e["type"] == "admit" for e in events) and \
                        ("q" in probed) == was_probed:
                    step_wall.append(time.perf_counter() - t0)
            wall = time.perf_counter() - t_start - probed.get("seconds", 0.0)
        outputs = [np.asarray(sess.completed[r].output) if r in sess.completed else None
                   for r in rids]
        eng = sess.engine
        admissions = [{"prompt_tokens": rep["prompt_tokens"],
                       "cached_tokens": rep["cached_tokens"],
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
            "admission_logits": rec["out"].get("admit_row"),
            "publish_read_bytes": sum(tr.read_bytes for tr in published),
            "publish_write_bytes": sum(tr.write_bytes for tr in published),
            "publish_seconds": sum(rec["publish"]),
            "accountant": eng.accountant.snapshot(),
            "stats": sess.stats(),
            "prefetch_deaths": eng.prefetcher.deaths if eng.prefetcher is not None else 0,
            "probe": probed or None,
        }


def run_main_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                  engine_cfg: EngineConfig | None = None, slots: int = 4,
                  n_requests: int = 6, prompt_len: tuple[int, int] = (1024, 2048),
                  max_new: int = 32, seed: int = 0, weights: tuple | None = None,
                  faults=None, probe: tuple[int, int] | None = None) -> dict:
    """Serve ``n_requests`` greedy requests (prompt lengths drawn uniformly
    from ``prompt_len``, ``max_new`` tokens each) over ``slots`` slots.

    ``n_layers`` cuts the depth (widths stay the config's).  ``weights``
    from :func:`build_weights` (same ``cfg``, ``n_layers``, ``prompt_len``
    and ``seed``) skips building the model; ``faults`` (a ``FaultPlan``)
    goes to the session.  Every kernel's launch count is set to 0 just
    before the drain and read just after.  ``outputs`` holds ``None`` for a
    request that failed.  ``probe = (step, layer)`` captures decode step
    ``step``'s tensors at model layer ``layer`` (:func:`_probed`) into
    ``probe`` for :func:`probe_fidelity`.
    """
    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    ecfg = engine_cfg or EngineConfig()
    calib, prompts = main_prompts(cfg, n_requests=n_requests, prompt_len=prompt_len, seed=seed)
    model, params, adapter = weights or _model_and_adapter(cfg, calib, rank=ecfg.rank,
                                                           seed=seed, dev=dev)
    run = _serve(model, params, adapter, ecfg, dev, prompts, max_new, slots=slots,
                 faults=faults, probe=probe)
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


# ---------------------------------------------------------------------------
# the full-cache device path (serving/decode.py) and Whisper through the engine
# ---------------------------------------------------------------------------


def device_prompts(vocab_size: int, *, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """:func:`run_device_path`'s prompts: one rectangular batch from numpy
    ``seed``."""
    return np.random.default_rng(seed).integers(0, vocab_size, (batch, prompt_len))


def _cut_blocks(cfg, n_layers: int | None):
    """``cfg`` cut to its first ``n_layers`` blocks (Whisper: that many
    encoder and decoder layers each); widths stay the config's."""
    if n_layers is None:
        return cfg
    if type(cfg).__name__ == "WhisperConfig":
        return dataclasses.replace(cfg, n_layers=n_layers, n_enc_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               block_pattern=cfg.block_pattern[:n_layers])


def run_device_path(cfg, mode: str, *, device=None, n_layers: int | None = None,
                    params: dict | None = None,
                    serve_cfg: D.KVSwapServeConfig | None = None, batch: int = 4,
                    prompt_len: int = 2048, max_new: int = 32, max_len: int = 4096,
                    seed: int = 0, enc_out: torch.Tensor | None = None,
                    forced: np.ndarray | None = None, keep_logits: bool = False) -> dict:
    """Serve ``batch`` seeded prompts of ``prompt_len`` tokens through the
    full-cache device path, as ``repro_torch.launch.serve --engine device``
    does: ``decode.prefill``, then ``max_new`` calls of ``decode.serve_step``,
    each fed the previous logits' greedy token (or ``forced[:, t]``, to hold
    two runs to one token sequence).

    ``mode`` is ``"full"`` (masked attention over the whole cache) or
    ``"kvswap"`` (``serve_cfg``'s grouped selection, kernel B on the card;
    with ``serve_cfg.rolling`` the rolling buffer is flushed every
    ``rb_len`` steps).  ``n_layers`` keeps the first blocks (widths stay the
    config's); ``params`` (for the cut config) skips drawing random weights
    from ``seed``; ``kvswap`` attaches random orthonormal adapters from
    ``seed``.  ``enc_out`` is Whisper's encoder output.  Every kernel's
    launch count is set to 0 just before the prefill and read just after
    the last step; peak device memory is counted from there too.
    ``keep_logits`` returns the prefill's and every step's logits on the
    host."""
    from repro_torch.configs import registry

    if mode not in ("full", "kvswap"):
        raise ValueError(f"mode must be 'full' or 'kvswap', got {mode!r}")
    dev = resolve(device)
    cfg = _cut_blocks(cfg, n_layers)
    if params is None:
        params = registry.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                                      device=dev)
    scfg = (serve_cfg or D.KVSwapServeConfig()) if mode == "kvswap" else None
    if scfg is not None:
        params = D.attach_kvswap_adapters(
            params, cfg, scfg.rank, generator=torch.Generator(device=dev).manual_seed(seed + 2))
    prompts = torch.as_tensor(device_prompts(cfg.vocab_size, batch=batch,
                                             prompt_len=prompt_len, seed=seed), device=dev)
    cache = D.init_cache(cfg, batch, max_len, kvswap=scfg, device=dev)
    step_wall, kept, toks, flushes = [], [], [], 0
    with _counted(HYBRID_KERNELS, dev) as launches:
        t0 = time.perf_counter()
        logits, cache = D.prefill(params, cfg, prompts, cache, kvswap=scfg, enc_out=enc_out)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        for t in range(max_new):
            if keep_logits:
                kept.append(logits.cpu())
            nxt = (logits.argmax(-1)[:, None] if forced is None
                   else torch.as_tensor(forced[:, t:t + 1], device=dev))
            toks.append(nxt[:, 0])
            t1 = time.perf_counter()
            logits, cache = D.serve_step(params, cfg, nxt, cache, kvswap=scfg, enc_out=enc_out)
            if scfg is not None and scfg.rolling and \
                    cache["length"] - cache["main_len"] == scfg.rb_len:
                cache = D.flush_rolling(params, cfg, cache, scfg)
                flushes += 1
            _sync(dev)
            step_wall.append(time.perf_counter() - t1)
            finite = finite and bool(torch.isfinite(logits).all())
        peak = _peak(dev)
    decode_s = sum(step_wall)
    return {"tokens": torch.stack(toks, 1).cpu().numpy(), "mode": mode,
            "n_layers": cfg.n_layers, "launches": launches, "logits_finite": finite,
            "prefill_seconds": prefill_s, "decode_step_wall_seconds": step_wall,
            "tokens_per_s": batch * max_new / decode_s, "peak_memory_bytes": peak,
            "length": cache["length"], "flushes": flushes,
            "logits": kept if keep_logits else None}


def whisper_weights(cfg, *, device=None, n_layers: int | None = None, batch: int = 4,
                    seed: int = 0) -> tuple:
    """``(cfg, params, enc_out, encode_seconds)`` for :func:`run_whisper_path`
    and :func:`run_device_path`: ``cfg`` cut to ``n_layers`` (encoder and
    decoder alike), random weights from ``seed``, and the encoder run once
    over ``batch`` seeded frame embeddings ``[batch, enc_frames, d_model]``
    (the stubbed front end's output)."""
    from repro_torch.models import whisper as W

    dev = resolve(device)
    cfg = _cut_blocks(cfg, n_layers)
    params = W.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    frames = torch.randn((batch, cfg.enc_frames, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1))
    _sync(dev)
    t0 = time.perf_counter()
    enc_out = W.encode(params, cfg, frames)
    _sync(dev)
    return cfg, params, enc_out, time.perf_counter() - t0


def run_whisper_path(cfg, *, device=None, n_layers: int | None = None,
                     weights: tuple | None = None, batch: int = 4,
                     engine_cfg: EngineConfig | None = None, prompt_len: int = 2048,
                     max_new: int = 32, seed: int = 0) -> dict:
    """Generate ``max_new`` greedy decoder tokens for ``batch`` seeded
    prompts of ``prompt_len`` tokens through ``KVSwapEngine.generate``, with
    the encoder's output over seeded frames set on the adapter
    (``set_encoder_output``).  Whisper's adapter has no ``gather_context``,
    so the engine assembles each step's context on the host whatever
    ``engine_cfg.device_resident`` says.

    ``weights`` from :func:`whisper_weights` (same ``cfg``, ``n_layers``,
    ``batch`` and ``seed``) skips building the model and running the
    encoder.  The low-rank adapter is fitted from decoder layer 0's K on one
    calibration prompt (with the first row's encoder output).  Every
    kernel's launch count is set to 0 just before ``generate`` and read
    just after."""
    from repro_torch.models.whisper import WhisperAdapter

    dev = resolve(device)
    cfg, params, enc_out, encode_s = weights or whisper_weights(
        cfg, device=dev, n_layers=n_layers, batch=batch, seed=seed)
    ecfg = engine_cfg or EngineConfig()
    rng = np.random.default_rng(seed)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (enc_out.shape[0], prompt_len))
    model = WhisperAdapter(cfg)
    model.set_encoder_output(params, enc_out[:1])
    pos = torch.arange(prompt_len, device=dev)[None]
    _, k0, _ = model.prefill_block(params, 0, model.embed(params, calib), pos)
    adapter = fit_adapter(k0[0].cpu().numpy(), rank=ecfg.rank, device=dev)
    del k0
    model.set_encoder_output(params, enc_out)
    with KVSwapEngine(model, params, ecfg, batch=enc_out.shape[0], adapter=adapter,
                      device=dev) as engine, \
            _watched(engine, dev, "prefill", "decode_step") as rec:
        with _counted(KERNELS, dev) as launches:
            t_start = time.perf_counter()
            tokens = engine.generate(prompts, max_new)
            wall = time.perf_counter() - t_start
        io_wait = [s.io_wait_seconds for s in engine.step_log]
        host_gather = not engine.device_resident
        peak = _peak(dev)
    return {
        "tokens": tokens, "n_layers": cfg.n_layers, "decode_steps": len(io_wait),
        "launches": launches, "logits_finite": rec["finite"], "host_gather": host_gather,
        "encode_seconds": encode_s, "wall_seconds": wall, "tokens_per_s": tokens.size / wall,
        "prefill_seconds": rec["prefill"][0], "decode_step_wall_seconds": rec["decode_step"],
        "decode_step_io_wait_seconds": io_wait, "peak_memory_bytes": peak,
    }


# ---------------------------------------------------------------------------
# the serving front half: the KV-affinity router and disaggregated prefill
# ---------------------------------------------------------------------------

# the SLO class of the reference's router tests (tests/test_router.py)
ROUTER_SLO = {"interactive": SLOClass("interactive", ttft_s=5.0, tpot_s=5.0)}


def router_trace(vocab_size: int, *, tenants: int = 3, turns: int = 3, sys_tokens: int = 1024,
                 user_tokens: int = 128, max_new: int = 16, turn_gap_s: float = 20.0,
                 seed: int = 0) -> Trace:
    """The router path's traffic: ``tenants`` chat conversations of
    ``turns`` turns (a ``sys_tokens`` system segment, then ``user_tokens``
    more a turn), interleaved by :func:`mixed_tenant_trace`.  Turns of one
    tenant are at least ``turn_gap_s`` modeled seconds apart."""
    return mixed_tenant_trace(seed, tenants=tenants, turns=turns, sys_tokens=sys_tokens,
                              user_tokens=user_tokens, max_new=max_new, turn_gap_s=turn_gap_s,
                              slo_classes=ROUTER_SLO, vocab_size=vocab_size)


def _cache(stack: contextlib.ExitStack, block_tokens: int, budget_bytes: int) -> PrefixCache:
    """A fresh prefix cache in its own temporary directory, both closed by
    ``stack``."""
    tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="prefix-cache-"))
    return stack.enter_context(PrefixCache(PrefixCacheConfig(
        block_tokens=block_tokens, kv_bits=16, budget_bytes=budget_bytes, dir=tmp)))


def _admissions(eng: KVSwapEngine, walls: list[float]) -> list[dict]:
    return [{"prompt_tokens": rep["prompt_tokens"], "cached_tokens": rep["cached_tokens"],
             "computed_tokens": rep["computed_tokens"], "wall_seconds": w}
            for rep, w in zip(eng.admit_log, walls)]


def _cache_view(cache: PrefixCache) -> tuple:
    """What scoring must leave unchanged: the stats, each block's LRU stamp
    and its pins."""
    return (dataclasses.asdict(cache.stats),
            {b: (m.last_used, m.pins)
             for b, m in (cache.manifest.blocks if cache.manifest else {}).items()})


def run_router_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                    engine_cfg: EngineConfig | None = None, weights: tuple | None = None,
                    trace: Trace | None = None, slots: int = 4,
                    block_tokens: int = 32, budget_bytes: int = 2 << 30, solo: bool = False,
                    peek: bool = False, trace_dir: str | None = None, seed: int = 0) -> dict:
    """Replay ``trace`` (default :func:`router_trace` at the config's vocab)
    through ``FrontEnd(pool, PrefixAffinityRouter())`` over two
    ``ServeSession(slots=...)``s, each with its own prefix cache in a
    temporary directory and its own ``Observability(labels={"replica": ...})``.

    Every kernel's launch count is set to 0 just before the replay and read
    just after.  ``requests`` holds each request's route, tenant, turn,
    modeled arrival, the modeled finish of the tenant's previous turn,
    cached and computed tokens and output.  ``solo`` then replays each
    replica's routed arrivals in a fresh session with a fresh cache and
    compares the tokens (``solo_equal``); ``peek`` scores every request
    against every replica ten times and compares each cache's stats, LRU
    stamps and pins before and after (``peek_neutral``); ``trace_dir``
    receives each replica's exported trace as ``<replica>.json``.
    """
    from repro_torch.obs import Observability
    from repro_torch.router import FrontEnd, PrefixAffinityRouter, ReplicaPool

    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    ecfg = engine_cfg or EngineConfig()
    model, params, adapter = weights or build_weights(cfg, device=dev, rank=ecfg.rank, seed=seed)
    trace = trace or router_trace(cfg.vocab_size, seed=seed)
    names = ["r0", "r1"]

    def session(stack, name=None):
        obs = Observability(labels={"replica": name}) if name else None
        return stack.enter_context(ServeSession(
            model, params, ecfg, slots=slots, adapter=adapter, device=dev, obs=obs,
            prefix_cache=_cache(stack, block_tokens, budget_bytes)))

    with contextlib.ExitStack() as stack:
        pool = ReplicaPool()
        recs = {}
        for name in names:
            sess = session(stack, name)
            pool.add(name, sess)
            recs[name] = stack.enter_context(_watched(sess.engine, dev, "decode_step",
                                                      "admit_row", "publish"))
        front = FrontEnd(pool, PrefixAffinityRouter())
        with _counted(KERNELS, dev) as launches:
            t0 = time.perf_counter()
            out = front.replay(trace)
            _sync(dev)
            wall = time.perf_counter() - t0
        peak = _peak(dev)
        requests, last_turn = [], {}
        for rid, r in enumerate(trace.requests):
            name = front.route_of(rid)
            req = pool[name].session.completed.get(front._routes[rid][1])
            prev = last_turn.get(r.tenant)
            requests.append({
                "replica": name, "tenant": r.tenant, "turn": 1 + (prev["turn"] if prev else 0),
                "arrival": r.arrival, "prev_finished_at": prev["finished_at"] if prev else None,
                "prompt_tokens": r.prompt_tokens, "max_new": r.max_new,
                "cached_tokens": req.cached_tokens if req else None,
                "finished_at": req.finished_at if req else None,
                "output": None if req is None else np.asarray(req.output)})
            last_turn[r.tenant] = requests[-1]
        run = {
            "n_layers": cfg.n_layers, "requests": requests, "fleet": out["fleet"],
            "launches": launches, "wall_seconds": wall, "peak_memory_bytes": peak,
            "tokens_per_s": sum(len(q["output"]) for q in requests
                                if q["output"] is not None) / wall,
            "logits_finite": all(rec["finite"] for rec in recs.values()),
            "decode_steps": {n: len(pool[n].session.engine.step_log) for n in names},
            "decode_step_wall_seconds": {n: recs[n]["decode_step"] for n in names},
            "admissions": {n: _admissions(pool[n].session.engine, recs[n]["admit_row"])
                           for n in names},
            "publish_seconds": {n: sum(recs[n]["publish"]) for n in names},
        }
        if trace_dir is not None:
            run["trace_files"] = {}
            for name in names:
                path = f"{trace_dir}/{name}.json"
                pool[name].session.obs.export_trace(path)
                run["trace_files"][name] = path
        if peek:
            before = [_cache_view(rep.cache) for rep in pool]
            for _ in range(10):
                for r in trace.requests:
                    prompt = r.materialize(trace.vocab_size)
                    for rep in pool:
                        front.policy.score(rep, prompt)
            run["peek_neutral"] = [_cache_view(rep.cache) for rep in pool] == before
        if solo:
            run["solo_equal"] = [None] * len(requests)
            for name in names:
                with contextlib.ExitStack() as solo_stack:
                    sess = session(solo_stack)
                    local = {rid: sess.submit(r.materialize(trace.vocab_size), r.max_new,
                                              arrival=r.arrival, slo_class=r.slo_class,
                                              tenant=r.tenant)
                             for rid, r in enumerate(trace.requests)
                             if requests[rid]["replica"] == name}
                    sess.drain()
                    for rid, lid in local.items():
                        got, want = requests[rid]["output"], sess.completed.get(lid)
                        run["solo_equal"][rid] = (got is not None and want is not None
                                                  and np.array_equal(got, want.output))
    return run


def disagg_prompts(vocab_size: int, *, n_requests: int, prompt_len: tuple[int, int],
                   seed: int) -> list[np.ndarray]:
    """``n_requests`` distinct prompts from numpy ``seed``, their lengths
    drawn uniformly from ``prompt_len`` before any token."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_len[0], prompt_len[1] + 1, n_requests)
    return [rng.integers(0, vocab_size, int(n)) for n in lens]


def run_disagg_path(cfg: ModelConfig, *, device=None, n_layers: int | None = None,
                    engine_cfg: EngineConfig | None = None, weights: tuple | None = None,
                    slots: int = 4, n_requests: int = 4,
                    prompt_len: tuple[int, int] = (1536, 2048), max_new: int = 16,
                    block_tokens: int = 32, budget_bytes: int = 4 << 30,
                    cache_faults=None, seed: int = 0) -> dict:
    """Serve ``n_requests`` greedy requests of distinct prompts, all
    arriving at 0, through ``DisaggFrontEnd``: one ``PrefillEngine("p0")``
    and one decode ``ServeSession(slots=...)`` over one shared prefix cache
    in a temporary directory; then the same requests in a co-located
    control session without the cache.

    Every kernel's launch count is set to 0 just before the front end's
    first step and read at its drain; ``prefill_launches`` counts the
    launches made inside the prefill engine's steps.  ``tickets`` holds each
    ticket's state, attempts, prefill and publish walls (its last attempt),
    published blocks, decode admission wall with its cached and computed
    tokens, and its first-token logits against the control's.

    ``cache_faults`` (a ``FaultPlan``) is attached to the cache until the
    first ticket is re-queued at the handoff (``requeued``: its rid, and
    whether a decode row had been given that ticket then); it is detached
    before the re-prefill, so the retried chain is clean.
    """
    from repro_torch.disagg import QUEUED, DisaggFrontEnd, PrefillEngine

    dev = resolve(device)
    cfg = _cut(cfg, n_layers)
    ecfg = engine_cfg or EngineConfig()
    model, params, adapter = weights or build_weights(cfg, device=dev, rank=ecfg.rank, seed=seed)
    prompts = disagg_prompts(cfg.vocab_size, n_requests=n_requests, prompt_len=prompt_len,
                             seed=seed)
    lens = [len(p) for p in prompts]
    if len(set(lens)) != len(lens):
        raise ValueError(f"prompt lengths {lens} must differ: admissions are matched by length")
    with contextlib.ExitStack() as stack:
        cache = _cache(stack, block_tokens, budget_bytes)
        pe = stack.enter_context(PrefillEngine("p0", model, params, ecfg, cache=cache,
                                               adapter=adapter, device=dev))
        ds = stack.enter_context(ServeSession(model, params, ecfg, slots=slots, adapter=adapter,
                                              device=dev, prefix_cache=cache))
        p_rec = stack.enter_context(_watched(pe.engine, dev, "admit_row", "publish"))
        d_rec = stack.enter_context(_watched(ds.engine, dev, "admit_row", "decode_step",
                                             keep=("admit_row",)))
        front = DisaggFrontEnd([pe], [ds], cache=cache)
        in_prefill = dict.fromkeys((k.__name__ for k in KERNELS), 0)
        prefill_step = pe.step
        passes: dict[int, dict] = {}      # each ticket's last prefill pass

        def counted_step():
            before = {k.__name__: k.launches for k in KERNELS}
            n0, n_adm = pe.published_blocks, len(p_rec["admit_row"])
            ticket = prefill_step()
            if ticket is not None and len(p_rec["admit_row"]) > n_adm:
                passes[ticket.rid] = {"prefill_seconds": p_rec["admit_row"][-1],
                                      "publish_seconds": p_rec["publish"][-1],
                                      "published_blocks": pe.published_blocks - n0}
            for k in KERNELS:
                in_prefill[k.__name__] += k.launches - before[k.__name__]
            return ticket

        pe.step = counted_step
        requeued = None
        try:
            if cache_faults is not None:
                cache.use_faults(cache_faults)
            with _counted(KERNELS, dev) as launches:
                t0 = time.perf_counter()
                rids = [front.submit({"prompt": p, "max_new": max_new, "arrival": 0.0})
                        for p in prompts]
                if cache_faults is not None:
                    while front.requeues == 0 and front.has_work:
                        front.step()
                    bounced = [t for t in front.tickets.values()
                               if t.state == QUEUED and t.attempts]
                    requeued = {"rids": [t.rid for t in bounced],
                                "decode_admitted": [t.decode_rid is not None for t in bounced],
                                "cache_stats": dataclasses.asdict(cache.stats)}
                    cache.use_faults(None)
                results = front.drain()
                _sync(dev)
                wall = time.perf_counter() - t0
        finally:
            del pe.step
        peak = _peak(dev)
        tickets = [front.tickets[r] for r in rids]
        d_adm = {a["prompt_tokens"]: a for a in _admissions(ds.engine, d_rec["admit_row"])}
        first_logits = dict(zip(d_adm, d_rec["out"]["admit_row"]))
        run = {
            "n_layers": cfg.n_layers, "prompt_lens": lens,
            "outputs": [None if r not in results else np.asarray(results[r]) for r in rids],
            "states": [t.state for t in tickets], "attempts": [t.attempts for t in tickets],
            "launches": launches, "prefill_launches": in_prefill,
            "decode_steps": len(ds.engine.step_log),
            "decode_step_wall_seconds": d_rec["decode_step"],
            "logits_finite": d_rec["finite"] and p_rec["finite"],
            "wall_seconds": wall, "peak_memory_bytes": peak,
            "tokens_per_s": sum(len(o) for o in results.values()) / wall,
            "tickets": [{**passes.get(r, {}), "decode_admission": d_adm.get(n)}
                        for r, n in zip(rids, lens)],
            "stats": front.stats(), "cache_stats": dataclasses.asdict(cache.stats),
            "requeued": requeued,
        }
    control = _serve(model, params, adapter, ecfg, dev, prompts, max_new, slots=slots,
                     keep_logits=True)
    c_logits = dict(zip((a["prompt_tokens"] for a in control["admissions"]),
                        control["admission_logits"]))
    run["control_outputs"] = control["outputs"]
    run["tokens_equal"] = [a is not None and b is not None and np.array_equal(a, b)
                           for a, b in zip(run["outputs"], control["outputs"])]
    run["first_logits"] = [
        {"max_abs_diff": float((first_logits[n] - c_logits[n]).abs().max()),
         "max_abs_logit": float(c_logits[n].abs().max()),
         "bits_equal": bool(torch.equal(first_logits[n], c_logits[n]))}
        for n in lens]
    return run


# ---------------------------------------------------------------------------
# the engine's card route against its CPU route
# ---------------------------------------------------------------------------

# the shape of the reference tests' tiny_cfg (tests/conftest.py)
TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=97)
ROUTE_ENGINE = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128,
                    device_resident=True)


@contextlib.contextmanager
def _selections_logged(log: list):
    """Log every selection the engine's predictor makes while inside: the
    group scores it ranked (kernel A's on the card, the plain version's on
    the CPU) and the chosen ``(ids, mask)``, all on the host."""
    from repro_torch.kernels import fused_predict as fp

    select = fp.select_groups

    def logged(gscores, n_select):
        ids, mask = select(gscores, n_select)
        log.append((gscores.cpu().numpy(), ids.cpu().numpy(), mask.cpu().numpy()))
        return ids, mask

    fp.select_groups = logged
    try:
        yield log
    finally:
        fp.select_groups = select


def _flip(s_a: np.ndarray, s_b: np.ndarray, only_a: set, only_b: set) -> dict:
    """One row whose selections differ: ``a`` chose the groups ``only_a``
    over ``only_b`` and ``b`` the other way round.  Each side's gap is how
    far its lowest chosen group lies above its highest passed-over one, in
    units of the row's score scale (its largest valid |score|); the flip
    is a near-tie when both gaps lie within the cross-device difference."""
    valid = s_b > -1e29
    scale = max(1.0, float(np.abs(s_b[valid]).max()))
    ia, ib = sorted(only_a), sorted(only_b)
    gap_a = float(s_a[ia].min() - s_a[ib].max()) / scale
    gap_b = float(s_b[ib].min() - s_b[ia].max()) / scale
    diff = float(np.abs(s_a[ia + ib] - s_b[ia + ib]).max()) / scale
    return {"groups_a": ia, "groups_b": ib, "gap_a": gap_a, "gap_b": gap_b,
            "score_diff": diff, "scale": scale}


def compare_routes(device=None, *, seed: int = 0) -> dict:
    """The same ``device_resident`` engine run on ``device`` (``None`` = the
    card) and on the CPU, on one set of weights (a ``tiny_cfg``-shaped model:
    2 layers, d_model 64, 4 heads, 2 KV heads, head_dim 16, vocab 97; random
    weights from ``seed``, drawn on the CPU and copied) and one adapter,
    greedily generating 12 tokens for 2 seeded prompts of 30 tokens.

    Returns both runs' tokens, the number of (step, layer, row) selections
    and of those that differ (``flips``, each with :func:`_flip`'s gaps:
    ``a`` is the card, ``b`` the CPU), and the kernels' launches on each
    side (0 on the CPU, which runs the plain versions)."""
    from repro_torch.bridge import params_from_numpy

    dev = resolve(device)
    cfg = ModelConfig(**TINY)
    batch, steps = 2, 12
    params = init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    calib = rng.standard_normal((256, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (batch, 30))
    runs = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = TransformerAdapter(cfg)
        with KVSwapEngine(model, params_from_numpy(params, d), EngineConfig(**ROUTE_ENGINE),
                          batch=batch,
                          adapter=fit_adapter(calib, rank=ROUTE_ENGINE["rank"], device=d),
                          device=d) as eng, _selections_logged([]) as log, \
                _counted(KERNELS, d) as launches:
            tokens = eng.generate(prompts, steps)
        runs[side] = {"tokens": tokens, "log": log, "launches": launches}
    card, cpu = runs["card"]["log"], runs["cpu"]["log"]
    if len(card) != len(cpu):
        raise RuntimeError(f"{len(card)} selections on the card, {len(cpu)} on the CPU")
    flips, n_sel = [], 0
    n_kv = len(cfg.kv_layers)
    for call, ((s_a, ids_a, m_a), (s_b, ids_b, m_b)) in enumerate(zip(card, cpu)):
        for row in range(batch):
            n_sel += 1
            sel_a, sel_b = set(ids_a[row][m_a[row]]), set(ids_b[row][m_b[row]])
            if sel_a != sel_b:
                flips.append({"step": call // n_kv, "layer": call % n_kv, "row": row,
                              **_flip(s_a[row], s_b[row], sel_a - sel_b, sel_b - sel_a)})
    return {"tokens_card": runs["card"]["tokens"], "tokens_cpu": runs["cpu"]["tokens"],
            "tokens_equal": bool(np.array_equal(runs["card"]["tokens"], runs["cpu"]["tokens"])),
            "selections": n_sel, "flips": flips,
            "launches_card": runs["card"]["launches"], "launches_cpu": runs["cpu"]["launches"]}


# ---------------------------------------------------------------------------
# the paper's offline tuner, and the baselines on one decode step's tensors
# ---------------------------------------------------------------------------


def model_dims(cfg: ModelConfig) -> hardware.ModelDims:
    """The tuner's dims of a config (``d_ff = cfg.d_ff or 4·d_model``, as the
    reference's ``examples/offline_tuning.py`` builds them).  A latent
    attention config's cached token is one record of ``kv_lora + rope``
    floats (one "head", one plane), as its engine stores it."""
    if cfg.latent:
        return hardware.LatentDims(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=1,
                                   head_dim=cfg.record_dim, d_ff=cfg.d_ff or 4 * cfg.d_model)
    return hardware.ModelDims(d_model=cfg.d_model, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                              d_ff=cfg.d_ff or 4 * cfg.d_model)


def tuned_engine_config(cfg: ModelConfig, *, b_max: int, s_max: int, budget_bytes: int,
                        disk: str = "nvme",
                        **engine_kw) -> tuple[tuner.TunedParams, EngineConfig]:
    """``tuner.solve`` at ``(b_max, s_max)`` for the config's dims and depth
    under a per-batch budget of ``budget_bytes`` on ``disk``, and the
    ``EngineConfig`` that takes its ``group_size``, ``n_select``, ``rank``
    and ``reuse_capacity`` (at least 16), with ``max_seq = s_max`` and
    ``engine_kw``.  The rank is passed on as tuned (kernel A takes any)."""
    tuned = tuner.solve(tuner.TunerInputs(dims=model_dims(cfg), n_layers=cfg.n_layers,
                                          b_max=b_max, s_max=s_max, budget_bytes=budget_bytes,
                                          disk=disk))
    # the reference's quickstart floor: the reuse buffer holds at least 16 groups
    ecfg = EngineConfig(group_size=tuned.group_size, n_select=tuned.n_select, rank=tuned.rank,
                        reuse_capacity=max(tuned.reuse_capacity, 16), max_seq=s_max,
                        disk=disk, **engine_kw)
    return tuned, ecfg


def baseline_policies(n_kv_heads: int, head_dim: int, *, group_size: int, rank: int) -> list:
    """The paper's §4.2 policies: FlexGen, InfiniGen, InfiniGen* (head
    aggregation), ShadowKV, Loki (their default settings) and KVSwap at the
    engine's group size and rank (its adapter fitted on the keys it scores)."""
    from repro_torch.core import baselines as BL

    return [BL.FlexGenPolicy(n_kv_heads, head_dim),
            BL.InfiniGenPolicy(n_kv_heads, head_dim),
            BL.InfiniGenPolicy(n_kv_heads, head_dim, head_agg=True),
            BL.ShadowKVPolicy(n_kv_heads, head_dim),
            BL.LokiPolicy(n_kv_heads, head_dim),
            BL.KVSwapPolicy(n_kv_heads, head_dim, group_size=group_size, rank=rank)]


def probe_fidelity(probe: dict, *, group_size: int, n_select: int, rank: int) -> dict:
    """Score a probe (``run_main_path(probe=...)``) on the host.

    ``recall``: :func:`~repro_torch.core.predictor.recall_at_m` of the
    engine's own selection against the top-M groups of
    :func:`~repro_torch.core.predictor.exact_group_scores` (the true query
    over the K that ``k_lr`` covers), over the active rows.  ``fidelity``:
    each baseline's ``evaluate_policy`` (as a dict) on the first active
    row's query and full K and V, in float64, at a budget of ``n_select ·
    group_size`` tokens."""
    from repro_torch.core import baselines as BL
    from repro_torch.core.predictor import exact_group_scores, recall_at_m, select_groups

    rows = [int(bi) for bi in probe["rows"]]
    m = probe["ids"].shape[1]
    oracle = []
    for bi in rows:
        k = torch.from_numpy(probe["k_disk"][bi][None])
        gs = exact_group_scores(torch.from_numpy(probe["q"][bi][None]), k, group_size)
        ids = select_groups(gs, n_select)[0][0].numpy()
        # a row with fewer than M groups: the engine's mask is off past them
        oracle.append(np.pad(ids, (0, m - len(ids))))
    recall = recall_at_m(probe["ids"][rows], np.stack(oracle), probe["mask"][rows])
    bi = rows[0]
    q, k, v = (np.asarray(a, np.float64) for a in (probe["q"][bi], probe["k"][bi],
                                                    probe["v"][bi]))
    budget = n_select * group_size
    fidelity = {}
    for pol in baseline_policies(k.shape[1], k.shape[2], group_size=group_size, rank=rank):
        fidelity[pol.name] = dataclasses.asdict(BL.evaluate_policy(pol, q, k, v, budget))
    return {"step": probe["step"], "layer": probe["layer"], "rows": rows, "row": bi,
            "n_tokens": k.shape[0], "budget_tokens": budget, "recall": recall,
            "fidelity": fidelity}
