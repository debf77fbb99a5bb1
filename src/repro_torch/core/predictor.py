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
:func:`predict_groups` (from the previous layer's input, no RoPE),
:func:`exact_group_scores` (the oracle from the true query and full K) and
:func:`recall_at_m` are the offline evaluation API, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lowrank import LowRankAdapter

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


def lowrank_queries(q: torch.Tensor, adapter: LowRankAdapter) -> torch.Tensor:
    """``Q_h A_{q(h)}`` for every query head → ``[B, H, r]`` (the reference
    also takes ``n_heads`` and drops it: ``q.shape[1]`` is the head count)."""
    return lowrank_queries_per_head(q, adapter.per_head)


def token_scores(q_lr: torch.Tensor, k_lr: torch.Tensor) -> torch.Tensor:
    """Approximate attention scores, summed over heads → ``[B, N]``."""
    return torch.einsum("bhr,bnr->bhn", q_lr, k_lr).sum(dim=1)


def group_scores(scores: torch.Tensor, group_size: int,
                 valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Reduce-max over groups of ``G`` consecutive tokens → ``[B, N // G]``.

    Tokens at or past ``valid_len`` (``[B]`` or one count for every row) are
    masked to ``NEG_INF``.  ``N`` must be a multiple of ``G``.
    """
    b, n = scores.shape
    if n % group_size:
        raise ValueError(f"token count {n} not a multiple of group size {group_size}")
    if valid_len is not None:
        pos = torch.arange(n, device=scores.device)[None, :]
        vl = torch.as_tensor(valid_len, device=scores.device).reshape(-1, 1)
        scores = scores.masked_fill(pos >= vl, NEG_INF)
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


def predict_groups(x: torch.Tensor, wq: torch.Tensor, adapter_a: torch.Tensor,
                   k_lr: torch.Tensor, valid_len: torch.Tensor,
                   cfg: PredictorConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """End-to-end prediction from the previous layer's input ``x [B,
    d_model]`` through layer *i*'s ``wq [d_model, H·d]`` (no norm, no RoPE,
    as the reference), the adapter ``[H_k·d, r]`` and ``k_lr [B, N, r]``
    (``N`` a multiple of ``G``) → ``(group_ids [B, M], mask)``.  Plain op by
    op: it is not on the engine's decode path."""
    b = x.shape[0]
    d = adapter_a.shape[0] // cfg.n_kv_heads
    q = (x @ wq).reshape(b, cfg.n_heads, d)
    adapter = LowRankAdapter(a=adapter_a, n_kv_heads=cfg.n_kv_heads, head_dim=d)
    scores = token_scores(lowrank_queries(q, adapter), k_lr)
    return select_groups(group_scores(scores, cfg.group_size, valid_len), cfg.n_select)


def exact_group_scores(q: torch.Tensor, k: torch.Tensor, group_size: int,
                       valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle group scores from the true query ``q [B, H, d]`` and the full
    K cache ``k [B, N, H_k, d]`` (head-summed exact scores)."""
    b, h, d = q.shape
    hk = k.shape[2]
    q_g = q.reshape(b, hk, h // hk, d)
    scores = torch.einsum("bkgd,bnkd->bkgn", q_g, k).sum(dim=(1, 2))
    return group_scores(scores, group_size, valid_len)


def recall_at_m(pred_ids, oracle_ids, mask) -> float:
    """Fraction of oracle top-M groups recovered by the predictor (rows'
    ids under ``mask``; tensors or arrays, on any device)."""
    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    pred, orac, msk = host(pred_ids), host(oracle_ids), host(mask)
    hits = total = 0
    for bi in range(pred.shape[0]):
        p = set(pred[bi][msk[bi]].tolist())
        o = set(orac[bi][msk[bi]].tolist())
        if o:
            hits += len(p & o)
            total += len(o)
    return hits / max(total, 1)
