"""Sequence-parallel KVSwap decode attention on ``torch.distributed``.

For ``long_500k``-class contexts the KV cache is split along the sequence
over one mesh axis, and each rank holds only its own slice.  Each rank:

1. scores its **local** ``K_lr`` slice against the (replicated) low-rank
   query with kernel A (paper Eq. 1, head-summed, masked past the context
   length, max per group of G),
2. selects its local top ``M / n_shards`` groups (a per-shard quota: the
   same as the global top M whenever the global winners spread no more than
   the quota per shard, and otherwise a documented approximation),
3. computes a **partial flash-decode** over its selected tokens,
   ``(m_i, l_i, o_i)`` = (local max logit, local normaliser, local output),
   in plain PyTorch: kernel B returns only the normalised output,
4. combines across ranks with the flash-decoding identity::

       m = max_i m_i;   w_i = l_i · exp(m_i − m);   o = Σ w_i o_i / Σ w_i

   as one ``all_reduce`` MAX of ``m`` and one SUM of ``[o_i·w_i, w_i]``, so
   only ``[B, H]``- and ``[B, H, d]``-sized partials cross, whatever the
   context length.  The last rank of the axis also attends the new token
   (it owns the append position).

:func:`reference_decode_attn` is the single-process oracle with the same
per-shard quota, on :func:`repro_torch.models.layers.decode_attention`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.layers import decode_attention

NEG = -1e30


def shard_scores(q_lr: torch.Tensor, k_lr: torch.Tensor, start: int, length, *,
                 group_size: int) -> torch.Tensor:
    """Kernel A over one shard: ``q_lr [B, H, r]``, the local ``k_lr [B,
    n_loc, r]`` starting at global position ``start``, tokens at or past
    ``length`` masked → ``[B, n_loc // G]`` group scores."""
    b, n_loc = k_lr.shape[:2]
    valid = (torch.as_tensor(length, device=k_lr.device) - start).clamp(0, n_loc)
    valid = valid.to(torch.int32).reshape(1).expand(b).contiguous()
    gsc = ops.lowrank_group_scores(q_lr, k_lr, valid, group_size=group_size)
    return gsc[:, : n_loc // group_size]


def shard_select(gsc: torch.Tensor, quota: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard's top ``min(quota, n_groups)`` groups → ``(gids, valid)``,
    ties to the lower index (a stable descending sort, as
    ``jax.lax.top_k``); ``valid`` is False where the score was masked."""
    top, gids = torch.sort(gsc, dim=1, descending=True, stable=True)
    m = min(quota, gsc.shape[1])
    return gids[:, :m], top[:, :m] > NEG / 2


def select_tokens(k, v, gids, valid, start: int, length, group_size: int):
    """The selected groups' tokens of the local ``k/v [B, n_loc, Hk, d]``
    and their mask (inside the context and a valid selection)."""
    b = k.shape[0]
    tok = (gids[..., None] * group_size
           + torch.arange(group_size, device=gids.device)).reshape(b, -1)
    rows = torch.arange(b, device=k.device)[:, None]
    mask = (start + tok < torch.as_tensor(length, device=k.device)) \
        & valid.repeat_interleave(group_size, dim=1)
    return k[rows, tok], v[rows, tok], mask


def shard_partial(q, k_sel, v_sel, mask, k_new, v_new, *, is_last: bool):
    """Partial flash-decode of ``q [B, H, d]`` over one shard's selected
    ``k_sel/v_sel [B, n, Hk, d]`` (``mask [B, n]``), plus the new token on
    the last shard → ``(m_i [B, H], l_i [B, H], o_i [B, H, d])`` with
    ``o_i`` normalised by ``max(l_i, 1e-30)`` (0 on an all-masked shard)."""
    b, h, d = q.shape
    k_all = torch.cat([k_sel, k_new[:, None]], dim=1)
    v_all = torch.cat([v_sel, v_new[:, None]], dim=1)
    mask = torch.cat([mask, torch.full((b, 1), is_last, device=q.device)], dim=1)
    hk = k_all.shape[2]
    keep = mask[:, None, None, :]
    s = torch.einsum("bkrd,bnkd->bkrn", q.reshape(b, hk, h // hk, d), k_all) / math.sqrt(d)
    s = s.float().masked_fill(~keep, NEG)
    m_i = s.amax(dim=-1)
    p = torch.exp(s - m_i[..., None]).masked_fill(~keep, 0.0)
    l_i = p.sum(dim=-1)
    o_i = torch.einsum("bkrn,bnkd->bkrd", p, v_all.float())
    o_i = o_i / l_i.clamp_min(1e-30)[..., None]
    return m_i.reshape(b, h), l_i.reshape(b, h), o_i.reshape(b, h, d)


def combine(m_i, l_i, o_i, group) -> torch.Tensor:
    """The flash-decoding combine over ``group`` (a process group, or a
    list of them when the shards lie over several mesh axes): an
    ``all_reduce`` MAX of ``m [B, H]`` and a SUM of ``[o_i·w_i, w_i]``
    (``[B, H, d + 1]``) over each."""
    groups = group if isinstance(group, (list, tuple)) else [group]
    m = m_i.clone()
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    w = l_i * torch.exp(m_i - m)
    acc = torch.cat([o_i * w[..., None], w[..., None]], dim=-1)
    for g in groups:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=g)
    return acc[..., :-1] / acc[..., -1:].clamp_min(1e-30)


def make_seqshard_decode_attn(mesh, *, axis: str = "data", group_size: int = 4,
                              n_select: int = 100, n_kv_heads: int):
    """The sequence-sharded decode attention of this rank over ``mesh``'s
    ``axis`` (a ``DeviceMesh``).

    The built ``attn(q, q_lr, k_lr, k, v, k_new, v_new, length)`` takes ``q
    [B, H, d]``, ``q_lr [B, H, r]`` and ``k_new/v_new [B, Hk, d]`` replicated,
    this rank's slice ``k_lr [B, n_loc, r]`` and ``k/v [B, n_loc, Hk, d]``
    (global positions from ``rank_in_axis · n_loc``), and ``length``, the
    context length (an int or a 0-d tensor) → ``[B, H, d]``, the same on
    every rank."""
    dim = mesh.mesh_dim_names.index(axis)
    n_shards = mesh.size(dim)
    rank = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    quota = max(1, n_select // n_shards)

    def attn(q, q_lr, k_lr, k, v, k_new, v_new, length):
        if k.shape[2] != n_kv_heads:
            raise ValueError(f"k has {k.shape[2]} KV heads, expected {n_kv_heads}")
        start = rank * k.shape[1]
        gsc = shard_scores(q_lr, k_lr, start, length, group_size=group_size)
        gids, valid = shard_select(gsc, quota)
        k_sel, v_sel, mask = select_tokens(k, v, gids, valid, start, length, group_size)
        m_i, l_i, o_i = shard_partial(q, k_sel, v_sel, mask, k_new, v_new,
                                      is_last=rank == n_shards - 1)
        return combine(m_i, l_i, o_i, group).to(q.dtype)

    return attn


def reference_decode_attn(q, q_lr, k_lr, k, v, k_new, v_new, length, *, group_size: int,
                          n_select: int, n_shards: int = 1) -> torch.Tensor:
    """Single-process oracle with the same per-shard quota: plain scores per
    shard, each shard's top groups, then one decode attention over every
    selected token and the new one."""
    b, n = k.shape[:2]
    n_loc = n // n_shards
    quota = max(1, n_select // n_shards)
    sel_k, sel_v, sel_mask = [], [], []
    for sh in range(n_shards):
        sl = slice(sh * n_loc, (sh + 1) * n_loc)
        scores = torch.einsum("bhr,bnr->bn", q_lr, k_lr[:, sl])
        pos = sh * n_loc + torch.arange(n_loc, device=k.device)
        scores = scores.masked_fill(~(pos < torch.as_tensor(length, device=k.device))[None], NEG)
        gsc = scores.reshape(b, n_loc // group_size, group_size).amax(dim=-1)
        gids, valid = shard_select(gsc, quota)
        ks, vs, mask = select_tokens(k[:, sl], v[:, sl], gids, valid, sh * n_loc, length,
                                      group_size)
        sel_k.append(ks)
        sel_v.append(vs)
        sel_mask.append(mask)
    return decode_attention(q, torch.cat(sel_k, 1), torch.cat(sel_v, 1), torch.cat(sel_mask, 1),
                            k_new, v_new)
