"""The training path, end to end: the port's train step
(:func:`repro_torch.training.train.make_train_step`) on a model built from a
config with seeded random weights, over :class:`~repro_torch.data.SyntheticLMStream`.

:func:`run_train_path` first takes steps over one fixed batch (an overfit:
the loss must fall on random weights), then runs
:func:`~repro_torch.training.train.train_loop` with every block
checkpointed (``remat=True``), and times one more forward and backward
apart.  It returns what a caller checks and reports: the losses, kernel C's
launches in each run, per-step walls, the forward and backward walls and
peak device memory.  :func:`run_train_checks` holds the step's variants to
each other on one batch: gradient accumulation against the full batch,
``remat`` against none, and a checkpoint's round trip.
"""

from __future__ import annotations

import os
import time

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.data import SyntheticLMStream
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.training.optim import AdamWConfig, adamw_init
from repro_torch.training.train import (TrainState, make_loss_fn, make_train_step, train_loop,
                                        value_and_grad)
from repro_torch.utils.treeops import tree_count, tree_leaves, tree_unflatten


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _remat_forward(params, cfg, tokens):
    return T.forward(params, cfg, tokens, remat=True)


def _batch(stream, step: int, batch: int, seq_len: int, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.long, device=dev)
            for k, v in stream.batch(step, batch, seq_len).items()}


def run_train_path(cfg, *, device=None, batch: int = 2, seq_len: int = 1024,
                   fixed_steps: int = 8, loop_steps: int = 4, lr: float = 1e-3,
                   warmup: int = 2, seed: int = 0) -> dict:
    """``fixed_steps`` train steps on one batch, then ``loop_steps`` of
    ``train_loop`` with ``remat=True``, on ``cfg`` with weights from
    ``seed``; kernel C's launches are counted from 0 over each run."""
    dev = resolve(device)
    params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    stream = SyntheticLMStream(cfg.vocab_size, seed=0)
    fixed = _batch(stream, 0, batch, seq_len, dev)
    step = make_train_step(T.forward, cfg, AdamWConfig(lr=lr), total_steps=fixed_steps,
                           warmup=warmup)
    state = TrainState(params, adamw_init(params))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.ssd_chunk.launches = 0
    losses, walls = [], []
    for _ in range(fixed_steps):
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, fixed)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    out = {"losses": losses, "step_wall_seconds": walls, "n_params": tree_count(params),
           "launches": ops.ssd_chunk.launches, "tokens": batch * seq_len,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}

    # one forward and one backward on the same batch, timed apart (not counted)
    loss_fn = make_loss_fn(T.forward, cfg)
    leaves = [t.requires_grad_() for t in tree_leaves(state.params)]
    _sync(dev)
    t0 = time.perf_counter()
    loss, _ = loss_fn(state.params, fixed)
    _sync(dev)
    t1 = time.perf_counter()
    torch.autograd.grad(loss, leaves, allow_unused=True)
    _sync(dev)
    out["forward_seconds"], out["backward_seconds"] = t1 - t0, time.perf_counter() - t1
    del loss, leaves

    ops.ssd_chunk.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    state, hist = train_loop(state.params, _remat_forward, cfg, stream, steps=loop_steps,
                             batch=batch, seq_len=seq_len, opt_cfg=AdamWConfig(lr=lr),
                             log_every=1, device=dev)
    _sync(dev)
    out.update(remat_losses=[h["loss"] for h in hist], remat_launches=ops.ssd_chunk.launches,
               remat_seconds=time.perf_counter() - t0)
    return out


def run_train_checks(cfg, *, device=None, batch: int = 2, seq_len: int = 512, workdir,
                     seed: int = 0) -> dict:
    """On one batch from the same weights: the step with ``accum_steps=2``
    against ``accum_steps=1`` (loss, params after the step, and the first
    moments, which hold the clipped grads), the loss and grads with
    ``remat=True`` against none, and ``save_pytree`` → ``load_pytree``."""
    dev = resolve(device)
    params = T.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    data = _batch(SyntheticLMStream(cfg.vocab_size, seed=0), 0, batch, seq_len, dev)

    def clone():
        return tree_unflatten(params, [t.detach().clone() for t in tree_leaves(params)])

    def max_diff(a, b) -> float:
        return max(float((x - y).detach().abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    out = {}
    steps = [make_train_step(T.forward, cfg, AdamWConfig(lr=1e-3), total_steps=4,
                             accum_steps=n) for n in (1, 2)]
    (s1, m1), (s2, m2) = [fn(TrainState(p, adamw_init(p)), data)
                          for fn, p in zip(steps, (clone(), clone()))]
    out["accum_loss"] = (float(m1["loss"]), float(m2["loss"]))
    out["accum_param_diff"] = max_diff(s1.params, s2.params)
    out["accum_mu_diff"] = max_diff(s1.opt.mu, s2.opt.mu)
    out["mu_max"] = max(float(t.abs().max()) for t in tree_leaves(s1.opt.mu))
    del s1, s2, m1, m2

    l0, _, g0 = value_and_grad(make_loss_fn(T.forward, cfg), params, data)
    l1, _, g1 = value_and_grad(make_loss_fn(_remat_forward, cfg), params, data)
    out["remat_loss"] = (float(l0), float(l1))
    out["remat_grad_diff"] = max(float((a - b).abs().max()) for a, b in zip(g0, g1))
    out["grad_max"] = max(float(g.abs().max()) for g in g0)
    out["remat_bit_equal"] = bool(torch.equal(l0, l1)) and all(
        torch.equal(a, b) for a, b in zip(g0, g1))
    del g0, g1

    path = os.path.join(workdir, "train_checks.npz")
    t0 = time.perf_counter()
    save_pytree(path, params)
    back = load_pytree(path, params)
    out["checkpoint_seconds"] = time.perf_counter() - t0
    out["checkpoint_bytes"] = os.path.getsize(path)
    out["checkpoint_bit_equal"] = all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(tree_leaves(back), tree_leaves(params)))
    os.remove(path)
    return out
