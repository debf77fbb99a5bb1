"""Grouped critical-KV-entry prediction (KVSwap §3.3, Eq. 1).

Given the previous layer's input, the predictor forms layer *i*'s query,
projects it per head through the low-rank adapter (``Q_h A_{q(h)}``),
scores every cached token against the compressed K cache, **sums the scores
across heads**, reduce-maxes within each group of ``G`` tokens and selects
the top-``M`` groups.

Scores stay fp32 with ``NEG_INF = -1e30`` for masked tokens and a
``> NEG_INF/2`` validity test, as the reference.  Selection breaks ties as
``jax.lax.top_k`` does — lower index first — through a stable descending
sort (``torch.topk`` promises no tie order on CUDA, and a different order
would fetch different groups).

:func:`fused_predict` here is the op-by-op composition; the engine's hot
path is :func:`repro_torch.kernels.fused_predict.fused_predict`, which
replaces scoring + head sum + group max with one kernel.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    group_size: int          # G
    n_select: int            # M  (number of groups to preload)
    n_heads: int             # H  (query heads)
    n_kv_heads: int          # H_k

    @property
    def heads_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def lowrank_queries_per_head(q: torch.Tensor, per_head_a: torch.Tensor) -> torch.Tensor:
    """``Q_h A_{q(h)}`` for every query head: ``q [B, H, d]``,
    ``per_head_a [H_k, d, r]`` → ``[B, H, r]`` (GQA map ``q(h) = h // rep``)."""
    heads_per_kv = q.shape[1] // per_head_a.shape[0]
    a_for_head = torch.repeat_interleave(per_head_a.to(q.dtype), heads_per_kv, dim=0)
    return torch.einsum("bhd,hdr->bhr", q, a_for_head)


def token_scores(q_lr: torch.Tensor, k_lr: torch.Tensor) -> torch.Tensor:
    """Approximate attention scores, summed over heads → ``[B, N]``."""
    return torch.einsum("bhr,bnr->bhn", q_lr, k_lr).sum(dim=1)


def group_scores(scores: torch.Tensor, group_size: int,
                 valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Reduce-max over groups of ``G`` consecutive tokens → ``[B, N // G]``.

    Tokens at or past ``valid_len [B]`` are masked to ``NEG_INF``.  ``N``
    must be a multiple of ``G``.
    """
    b, n = scores.shape
    if n % group_size:
        raise ValueError(f"token count {n} not a multiple of group size {group_size}")
    if valid_len is not None:
        pos = torch.arange(n, device=scores.device)[None, :]
        scores = scores.masked_fill(pos >= valid_len.reshape(-1, 1), NEG_INF)
    return scores.reshape(b, n // group_size, group_size).amax(dim=-1)


def select_groups(gscores: torch.Tensor, n_select: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``M`` group ids by representative score, lower index first on ties.

    Returns ``(ids [B, M], mask [B, M])`` — mask is False where the score was
    masked (fewer than M valid groups exist); ids for masked slots are 0.
    """
    m = min(n_select, gscores.shape[-1])
    top, ids = torch.sort(gscores, dim=-1, descending=True, stable=True)
    top, ids = top[:, :m], ids[:, :m]
    mask = top > NEG_INF / 2
    return torch.where(mask, ids, torch.zeros_like(ids)), mask


def fused_predict(q: torch.Tensor, per_head_a: torch.Tensor, k_lr: torch.Tensor,
                  valid_len: torch.Tensor, *, group_size: int,
                  n_select: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1 scoring → group reduce-max → top-M, op by op (the reference
    composition the kernel path is held to)."""
    q_lr = lowrank_queries_per_head(q, per_head_a)
    gs = group_scores(token_scores(q_lr, k_lr), group_size, valid_len)
    return select_groups(gs, n_select)
