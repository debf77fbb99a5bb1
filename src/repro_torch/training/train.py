"""Training loop: the cross-entropy LM objective (+ the MoE load-balance
loss) and an eager train step with gradients from ``torch.autograd`` (the
reference jits a ``jax.value_and_grad`` step; there is no
``torch.compile`` here)."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve
from repro_torch.sharding.partition import (P, axis_index, axis_size, batch_axes, gather_over,
                                            local_region, partial_placements, split_axes,
                                            sum_over)
from repro_torch.training.optim import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.utils.treeops import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: object
    opt: AdamWState


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  ``logits [B, S, V]``, ``targets [B, S]`` int.
    On DTensors each rank works on its shard (:func:`_token_nll`)."""
    return _token_nll(logits, targets.long()).mean()


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood ``[B, S]``; on DTensors on each
    rank's shard: rows over the batch axes, the vocab over ``model`` where
    it divides (the log-sum-exp summed over ``model``, a rank's targets
    outside its vocab slice giving 0, the result a partial sum over
    ``model``).  DTensor's own softmax and gather would gather the vocab
    and take the gather's backward at the global shape."""

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), logits.shape[0])
        m = split_axes(mesh, "model", logits.shape[-1])
        kw = {"split": (mesh, axis_index(mesh, m) * (logits.shape[-1] // axis_size(mesh, m)),
                        axis_size(mesh, m))}
        return ([P(dp, None, m), P(dp, None)], partial_placements(mesh, P(dp, None), m), kw)

    return local_region(_nll_local, (logits, targets), layout)


def _nll_local(logits: torch.Tensor, targets: torch.Tensor, *, split: tuple | None = None):
    """``-log_softmax(logits)`` at ``targets``.  With ``split = (mesh, v0,
    n)`` ``logits`` is the vocab slice ``[v0, v0 + V_local)`` of ``n`` over
    ``model``: the log-sum-exp is taken over every slice (its maximum
    detached: the result does not depend on it), and this rank's share is
    ``lse / n`` less its own target's logit (0 outside its slice)."""
    if split is None:
        return -torch.log_softmax(logits.float(), dim=-1).gather(-1, targets[..., None])[..., 0]
    mesh, v0, n = split
    x = logits.float()
    top = x.amax(dim=-1, keepdim=True).detach()
    if n > 1:
        top = gather_over(top, mesh, "model", -1).amax(dim=-1, keepdim=True)
        lse = top[..., 0] + torch.log(sum_over(torch.exp(x - top).sum(dim=-1), mesh, "model"))
    else:
        lse = top[..., 0] + torch.log(torch.exp(x - top).sum(dim=-1))
    local = targets - v0
    mine = (local >= 0) & (local < x.shape[-1])
    picked = x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
    return lse / n - picked * mine.to(x.dtype)


def make_loss_fn(forward: Callable, cfg, *, aux_weight: float = 0.01):
    """``forward(params, cfg, tokens) -> (logits, aux)``; Whisper passes
    ``forward(params, cfg, tokens, enc_out)`` through a closure instead."""

    def loss_fn(params, batch):
        logits, aux = forward(params, cfg, batch["tokens"])
        loss = softmax_xent(logits, batch["targets"])
        if aux is not None:
            loss = loss + aux_weight * aux
        return loss, {"xent": loss, "aux": aux if aux is not None else 0.0}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch)``'s ``(loss, metrics, grads)`` (the port's
    ``jax.value_and_grad(loss_fn, has_aux=True)``): every metric detached,
    ``grads`` the leaves' gradients in :func:`tree_leaves` order (zeros for
    a leaf the loss does not reach)."""
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(forward: Callable, cfg, opt_cfg: AdamWConfig | None = None,
                    *, total_steps: int = 1000, warmup: int = 50,
                    aux_weight: float = 0.01, accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; the params and the
    moments are updated in place.  ``accum_steps > 1`` splits the batch into
    that many microbatches (rows in order, as the reference's reshape) and
    averages their gradients: the same update as the full batch for a mean
    loss, with one microbatch's activations live at a time."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(forward, cfg, aux_weight=aux_weight)

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            micro = {k: t.reshape(accum_steps, t.shape[0] // accum_steps, *t.shape[1:])
                     for k, t in batch.items()}
            grads, loss = None, 0.0
            for i in range(accum_steps):
                l, _, g = value_and_grad(loss_fn, state.params, {k: t[i] for k, t in micro.items()})
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
                loss = loss + l
            torch._foreach_div_(grads, accum_steps)
            loss = loss / accum_steps
            metrics = {"xent": loss, "aux": 0.0}
        lr = cosine_lr(state.opt.step, base_lr=opt_cfg.lr, warmup=warmup, total=total_steps)
        params, opt = adamw_update(state.params, tree_unflatten(state.params, grads), state.opt,
                                   opt_cfg, lr=lr)
        return TrainState(params, opt), dict(metrics, loss=loss, lr=lr)

    return train_step


def train_loop(params, forward, cfg, stream, *, steps: int, batch: int, seq_len: int,
               opt_cfg: AdamWConfig | None = None, log_every: int = 10,
               checkpoint_cb: Callable | None = None, device=None):
    """A host loop over a :class:`~repro_torch.data.SyntheticLMStream` (or
    compatible), its batches moved to ``device`` (``None`` = the CUDA card),
    where ``params`` must live."""
    dev = resolve(device)
    state = TrainState(params, adamw_init(params))
    step_fn = make_train_step(forward, cfg, opt_cfg, total_steps=steps)
    history = []
    t0 = time.time()
    for step in range(steps):
        batch_np = stream.batch(step, batch, seq_len)
        batch_dev = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                     for k, v in batch_np.items()}
        state, metrics = step_fn(state, batch_dev)
        if step % log_every == 0 or step == steps - 1:
            loss, lr = float(metrics["loss"]), float(metrics["lr"])
            history.append({"step": step, "loss": loss, "lr": lr, "wall": time.time() - t0})
            print(f"step {step:5d}  loss {loss:.4f}  lr {lr:.2e}")
        if checkpoint_cb is not None and step and step % 100 == 0:
            checkpoint_cb(state, step)
    return state, history
