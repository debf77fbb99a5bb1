"""AdamW with a cosine schedule over a param tree, with the reference's
arithmetic: global-norm clipping to ``grad_clip``, bias corrections from
the incremented step, and decoupled weight decay inside the update.

The update runs under ``torch.no_grad`` with ``torch._foreach_*`` ops and
writes the params and both moments in place (the reference returns new
trees; a copy of every param a step is memory the card does not need to
spend).  ``torch.optim.AdamW`` is not used: its step and clipping order are
its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.utils.treeops import tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the params' device
    mu: object           # first-moment tree
    nu: object           # second-moment tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda: tree_unflatten(params, [torch.zeros_like(t) for t in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                      mu=zeros(), nu=zeros())


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac · base_lr``, as a 0-d
    float32 tensor on ``step``'s device (``step`` an int or a tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig, lr=None):
    """One AdamW step with global-norm clipping: ``params`` and ``state``'s
    moments are updated in place and returned as ``(params, state)`` with
    the step incremented.  ``grads`` (a tree of ``params``' structure) is
    left as it was."""
    lr = cfg.lr if lr is None else lr
    p, m, v = tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)
    g = tree_leaves(grads)
    scale = torch.clamp(cfg.grad_clip / (global_norm(g) + 1e-9), max=1.0)
    g = torch._foreach_mul(g, scale)
    step = state.step + 1
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    torch._foreach_mul_(m, cfg.b1)                       # m = b1·m + (1 − b1)·g
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(g, g)                            # v = b2·v + (1 − b2)·g²
    torch._foreach_mul_(g, 1 - cfg.b2)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, g)
    del g
    upd = torch._foreach_div(m, b1c)                     # m̂
    den = torch._foreach_div(v, b2c)                     # v̂
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(upd, den)                        # m̂ / (√v̂ + eps)
    del den
    torch._foreach_add_(upd, p, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(p, upd)                          # p − lr·(… + wd·p)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
