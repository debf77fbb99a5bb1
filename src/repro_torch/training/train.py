"""Training loop: the cross-entropy LM objective (+ the MoE load-balance
loss) and an eager train step with gradients from ``torch.autograd`` (the
reference jits a ``jax.value_and_grad`` step; there is no
``torch.compile`` here)."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve
from repro_torch.training.optim import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.utils.treeops import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: object
    opt: AdamWState


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  ``logits [B, S, V]``, ``targets [B, S]`` int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


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
