"""Shared building blocks of the attention path: norms (RMS and layer norm),
RoPE, GQA attention (causal, chunked, bidirectional and one-token decode),
SwiGLU, the GELU MLP and top-k routed MoE — the PyTorch port of
:mod:`repro.models.layers`.

On DTensor params (a mesh of ``data`` and ``model`` axes) the attention,
the linears, the embedding and the MoE dispatch run on each rank's shard
through :func:`repro_torch.sharding.partition.local_region`, in the
reference's layouts: rows over the batch axes, heads, FFN columns, experts
and vocab rows over ``model``.  On plain tensors every one of them runs
the plain code below.

Plain functions on tensors; params are plain dicts of tensors with the
reference's layout (weights ``[in, out]``, applied as ``x @ w``).  Decode
attention goes through :func:`repro_torch.kernels.ops.gather_attention`,
which launches the CUDA flash-decode kernel for a CUDA tensor and runs its
plain version for a CPU tensor — there is no module-level switch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.partition import (P, axis_index, axis_size, batch_axes, constrain,
                                            gather_over, local_region, mesh_of, partial_placements,
                                            shard_dim, split_axes, sum_over)

# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, *, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in fp32 (biased variance, as the reference)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (split-halves convention, as the reference)
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 500000.0) -> torch.Tensor:
    """Rotary embedding.  ``x: [..., seq, heads, d]`` (or ``[..., heads, d]``
    with matching positions), ``positions: [..., seq]``."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [d/2]
    angles = positions[..., None].float() * freqs            # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]                    # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def yarn_inv_freq(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """YaRN's NTK-by-parts inverse frequencies (arXiv:2309.00071) on ``dim``
    rotary dims, as DeepSeek-V3's ``yarn`` rope computes them: a dimension
    that turns more than ``beta_fast`` times over the original context keeps
    its frequency, one that turns fewer than ``beta_slow`` times has it
    divided by ``factor``, and a linear ramp joins the two (its ends floored
    and ceiled to whole dims).  Computed in float64 and rounded once: at
    positions of thousands an ulp of a frequency turns a pair by 1e-4."""
    def corr_dim(rotations: float) -> float:
        return (dim * math.log(yarn.original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(corr_dim(yarn.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    f64 = dict(dtype=torch.float64, device=device)
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, **f64) / dim)
    ramp = ((torch.arange(dim // 2, **f64) - low) / (high - low)).clamp(0.0, 1.0)
    return (extra / yarn.factor * ramp + extra * (1.0 - ramp)).float()


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on interleaved pairs: ``(x[2i], x[2i+1])`` turned by
    ``positions · inv_freq[i]``, the output in the same order.  Shapes as
    :func:`apply_rope`."""
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    pairs = x.float().unflatten(-1, (-1, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; on DTensors a vocab-parallel lookup on each rank's
    shard: the table's rows over ``model`` (where they divide), each rank
    looking up the tokens in its rows (0 elsewhere), the rows of ``tokens``
    over the batch axes, the result a partial sum over ``model``.  For a few
    tokens (:func:`moves_activations`) a table split over ``data`` as well
    (FSDP) stays where it is: every token comes to each rank's block ``[V/m,
    D/d]``, and the looked-up rows leave split over ``data`` along ``D``."""

    def layout(mesh):
        m = split_axes(mesh, "model", embed.shape[0])
        kw = {"v0": axis_index(mesh, m) * (embed.shape[0] // axis_size(mesh, m))}
        if moves_activations(mesh, tokens.numel(), embed, 1,
                             embed.shape[1] // axis_size(mesh, "data")):
            return ([P(m, "data"), P()],
                    partial_placements(mesh, P(*[None] * tokens.dim(), "data"), m), kw)
        dp = split_axes(mesh, batch_axes(mesh), tokens.shape[0])
        return [P(m, None), P(dp)], partial_placements(mesh, P(dp), m), kw

    return local_region(_embed_rows, (embed, tokens), layout)


def _embed_rows(embed: torch.Tensor, tokens: torch.Tensor, *, v0: int | None = None):
    """``embed[tokens]``, or with ``v0`` the rows ``[v0, v0 + len(embed))``
    of a larger table: tokens outside them give 0."""
    if v0 is None:
        return embed[tokens]
    local = tokens - v0
    mine = (local >= 0) & (local < embed.shape[0])
    return embed[local.clamp(0, embed.shape[0] - 1)] * mine[..., None].to(embed.dtype)


def moves_activations(mesh, tokens: int, w: torch.Tensor, w_dim: int, moved: int,
                      axis: str = "data") -> bool:
    """Whether a product of ``tokens`` rows with weight ``w`` (dim ``w_dim``
    split over mesh axis ``axis``: ``data`` for FSDP) should bring the rows
    to the weight's shards, or move them between its shards, instead of
    moving the weight: when the ``moved`` elements a token sends (its slice
    in, its partial sum out) for every token are fewer than the elements of
    ``w``'s local shard (a decode step)."""
    return shard_dim(w, axis) == w_dim and tokens * moved < _shard_numel(w)


def _shard_numel(w: torch.Tensor) -> int:
    """The elements of one rank's shard of DTensor ``w`` (of ``w`` itself
    for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    n = w.numel()
    if isinstance(w, DTensor):
        for i, p in enumerate(w.placements):
            if isinstance(p, Shard):
                n //= w.device_mesh.size(i)
    return n


def linear_cols(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; on DTensors a column-parallel product on each rank's
    shard: ``x``'s rows over the batch axes and whole over ``model``, ``w
    [in, out]`` whole but for its output columns over ``model`` (where they
    divide) — a weight split over ``data`` (FSDP) is gathered first — and
    the output's last dim over ``model``.  For a few tokens
    (:func:`moves_activations`) the FSDP weight stays where it is: the rows
    come whole to every rank, split along ``in`` as ``w`` is, and the
    output is a partial sum over ``data``."""

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), x.shape[0])
        m = split_axes(mesh, "model", w.shape[-1])
        lead = [None] * (x.dim() - 1)
        tokens, (n_in, n_out) = x.numel() // x.shape[-1], w.shape
        if moves_activations(mesh, tokens, w, 0, n_in // axis_size(mesh, "data")
                             + n_out // axis_size(mesh, m)):
            return ([P(*lead, "data"), P("data", m)],
                    partial_placements(mesh, P(*lead, m), "data"), {})
        return [P(dp), P(None, m)], P(dp, *lead[1:], m), {}

    return local_region(torch.matmul, (x, w), layout)


def linear_rows(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w``; on DTensors a row-parallel product on each rank's shard:
    ``h``'s last dim and ``w``'s input rows over ``model`` (where they
    divide), the output a partial sum over ``model``.  For a few tokens an
    FSDP weight's ``data`` split of its output columns stays, and the rows
    come whole (:func:`linear_cols`)."""

    def layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), h.shape[0])
        m = split_axes(mesh, "model", w.shape[0])
        lead = [None] * (h.dim() - 1)
        tokens, (n_in, n_out) = h.numel() // h.shape[-1], w.shape
        if moves_activations(mesh, tokens, w, 1, n_in // axis_size(mesh, m)
                             + n_out // axis_size(mesh, "data")):
            return ([P(*lead, m), P(m, "data")],
                    partial_placements(mesh, P(*lead, "data"), m), {})
        return ([P(dp, *lead[1:], m), P(m, None)], partial_placements(mesh, P(dp), m), {})

    return local_region(torch.matmul, (h, w), layout)


def dense_init(fan_in: int, fan_out: int, *, generator: torch.Generator, device,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """``N(0, scale²)`` weights ``[fan_in, fan_out]``, drawn from ``generator``;
    ``scale`` defaults to ``1/sqrt(fan_in)``, as the reference's."""
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn((fan_in, fan_out), generator=generator, device=device,
                       dtype=dtype).mul_(s)


def init_attention(*, generator: torch.Generator, device, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype=torch.float32) -> dict:
    """Q, K, V and O projections in the reference layout, ``N(0, 1/fan_in)``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"wq": dense_init(d_model, n_heads * head_dim, **kw),
            "wk": dense_init(d_model, n_kv_heads * head_dim, **kw),
            "wv": dense_init(d_model, n_kv_heads * head_dim, **kw),
            "wo": dense_init(n_heads * head_dim, d_model, **kw)}


def attention_qkv(p, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, rope_theta: float, qk_norm: bool):
    """Project + (qk-)norm + RoPE.  ``x: [B, S, D]`` → q [B,S,H,d], k/v [B,S,Hk,d]."""
    return split_heads(x @ p["wq"], x @ p["wk"], x @ p["wv"], positions, p, head_dim=head_dim,
                       rope_theta=rope_theta, qk_norm=qk_norm)


def split_heads(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, positions, norms, *,
                head_dim: int, rope_theta: float | None, qk_norm: bool = False):
    """Flat projections ``[..., heads·d]`` → ``[..., heads, d]``, with the
    qk-norm (``norms["q_norm"]``, ``norms["k_norm"]``) and RoPE at
    ``positions`` unless ``rope_theta`` is ``None``."""
    q, k, v = (t.reshape(*t.shape[:-1], -1, head_dim) for t in (qf, kf, vf))
    if qk_norm:
        q = rmsnorm(norms["q_norm"], q)
        k = rmsnorm(norms["k_norm"], k)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def head_layout(mesh, batch: int, n_heads: int, n_kv_heads: int):
    """How attention lies over ``mesh``: ``(dp, hq, hkv, h0)`` — the axes
    that split the batch, the query heads and the KV heads (``None`` where a
    dim stays whole: it does not divide, or the query heads' share would
    straddle a KV head's group), and this rank's first query head."""
    dp = split_axes(mesh, batch_axes(mesh), batch) if mesh is not None else None
    hq = split_axes(mesh, "model", n_heads)
    rep, hl = n_heads // n_kv_heads, n_heads // axis_size(mesh, hq)
    if hq is not None and hl % rep and rep % hl:
        hq = None
    hkv = split_axes(mesh, "model", n_kv_heads) if hq is not None else None
    return dp, hq, hkv, axis_index(mesh, hq) * hl if hq is not None else 0


def local_kv_heads(k: torch.Tensor, h0: int, hl: int, rep: int) -> torch.Tensor:
    """The KV heads ``[..., Hk, d]`` that query heads ``[h0, h0 + hl)`` read
    (GQA groups of ``rep``): one head when ``hl < rep``."""
    first = h0 // rep
    return k[..., first:first + max(1, hl // rep), :]


def column_layout(mesh, n_heads: int, head_dim: int):
    """``(c0, cl)``, the columns ``[c0, c0 + cl)`` of the flat attention
    output ``[..., H·d]`` that this rank's ``wo`` rows take, where the query
    heads do not split over ``model`` but their columns do (Whisper's 20
    heads, Maverick's 40 over 16); ``None`` otherwise."""
    m = axis_size(mesh, "model")
    if split_axes(mesh, "model", n_heads) is not None or m == 1 or (n_heads * head_dim) % m:
        return None
    cl = n_heads * head_dim // m
    return axis_index(mesh, "model") * cl, cl


def _column_heads(qf, cols: tuple, head_dim: int, rep: int):
    """The query heads that cover columns ``cols = (c0, cl)`` of the flat
    output → ``(qf [..., h·d]`` of those heads, the KV head of each of them,
    the first column's place in them)."""
    c0, cl = cols
    h_lo, h_hi = c0 // head_dim, -(-(c0 + cl) // head_dim)
    kv = torch.arange(h_lo, h_hi, device=qf.device) // rep
    return qf[..., h_lo * head_dim:h_hi * head_dim], kv, c0 - h_lo * head_dim


def _attention_local(qf, kf, vf, positions, norms, *, attend, head_dim: int, rope_theta,
                     qk_norm: bool, rep: int, kv_from: int | None = None,
                     cols: tuple | None = None):
    """One rank's attention over its heads: ``qf [B,S,Hl·d]``, ``kf/vf``
    its KV heads, or all of them when ``kv_from`` (its first query head)
    is given → ``(o [B,S,Hl·d], k, v)``, ``k/v`` post-RoPE as given.  With
    ``cols``, ``qf`` and ``kf/vf`` are whole and ``o`` is the columns
    ``cols`` of the flat output (:func:`column_layout`): only the heads
    that cover them are computed."""
    if cols is not None:
        qf, kv, off = _column_heads(qf, cols, head_dim, rep)
    q, k, v = split_heads(qf, kf, vf, positions, norms, head_dim=head_dim,
                          rope_theta=rope_theta, qk_norm=qk_norm)
    kq, vq = k, v
    if cols is not None:
        o = attend(q, k.index_select(-2, kv), v.index_select(-2, kv))
        return o.reshape(*o.shape[:-2], -1)[..., off:off + cols[1]], k, v
    if kv_from is not None:
        kq = local_kv_heads(k, kv_from, q.shape[-2], rep)
        vq = local_kv_heads(v, kv_from, q.shape[-2], rep)
    o = attend(q, kq, vq)
    return o.reshape(*o.shape[:-2], -1), k, v


def attention(p, x: torch.Tensor, positions, *, n_heads: int, n_kv_heads: int, head_dim: int,
              attend, rope_theta: float | None = None, qk_norm: bool = False):
    """Q/K/V projections of ``x [B, S, D]``, qk-norm and RoPE, and
    ``attend(q, k, v)`` (causal or bidirectional) → ``(o [B, S, H·d]``
    before ``wo``, ``k, v)``.

    On DTensors the projections are column-parallel (:func:`linear_cols`)
    and the rest runs on each rank's shard
    (:func:`~repro_torch.sharding.partition.local_region`): batch over the
    batch axes, query heads over ``model`` where they divide
    (:func:`head_layout`); KV heads that do not divide arrive whole and
    each rank attends with its query heads' group.  Query heads that do not
    divide ``model`` arrive whole, and each rank attends with the heads
    that cover its share of ``wo``'s rows (:func:`column_layout`): the
    output comes back split over ``model`` by columns.
    """
    qf, kf, vf = (linear_cols(x, p[w]) for w in ("wq", "wk", "wv"))
    norms = {k: p[k] for k in ("q_norm", "k_norm") if qk_norm}

    def layout(mesh):
        dp, hq, hkv, h0 = head_layout(mesh, x.shape[0], n_heads, n_kv_heads)
        cols = column_layout(mesh, n_heads, head_dim)
        kv = P(dp, None, hkv)
        o, k4 = P(dp, None, "model" if cols else hq), P(dp, None, hkv, None)
        return ([P(dp, None, hq), kv, kv, P(dp, None), P()], [o, k4, k4],
                {"kv_from": h0 if hq is not None and hkv is None else None, "cols": cols})

    return local_region(
        functools.partial(_attention_local, attend=attend, head_dim=head_dim,
                          rope_theta=rope_theta, qk_norm=qk_norm, rep=n_heads // n_kv_heads),
        (qf, kf, vf, positions, norms), layout)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., Hk, d] -> [..., Hk*n_rep, d]"""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def split_kv(kf: torch.Tensor, vf: torch.Tensor, *, n_heads: int, n_kv_heads: int,
             head_dim: int):
    """Flat K/V projections ``[B, S, Hk·d]`` → ``[B, S, Hk, d]``; on
    DTensors on each rank's shard, with the KV heads over ``model`` as
    :func:`attention` lays them."""

    def layout(mesh):
        dp, _, hkv, _ = head_layout(mesh, kf.shape[0], n_heads, n_kv_heads)
        return [P(dp, None, hkv)] * 2, [P(dp, None, hkv, None)] * 2, {}

    return local_region(lambda k, v: (k.reshape(*k.shape[:-1], -1, head_dim),
                                      v.reshape(*v.shape[:-1], -1, head_dim)), (kf, vf), layout)


def _attend_local(qf, k, v, *, attend, rep: int, kv_from: int | None = None,
                  cols: tuple | None = None):
    if cols is not None:
        qf, kv, off = _column_heads(qf, cols, k.shape[-1], rep)
        o = attend(qf.reshape(*qf.shape[:-1], -1, k.shape[-1]), k.index_select(-2, kv),
                   v.index_select(-2, kv))
        return o.reshape(*o.shape[:-2], -1)[..., off:off + cols[1]]
    q = qf.reshape(*qf.shape[:-1], -1, k.shape[-1])
    if kv_from is not None:
        k = local_kv_heads(k, kv_from, q.shape[-2], rep)
        v = local_kv_heads(v, kv_from, q.shape[-2], rep)
    o = attend(q, k, v)
    return o.reshape(*o.shape[:-2], -1)


def attend_heads(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_heads: int,
                 attend) -> torch.Tensor:
    """``attend`` of the flat queries ``qf [B, S, H·d]`` over given ``k/v
    [B, Sk, Hk, d]`` (:func:`split_kv`) → ``[B, S, H·d]``, laid out on
    DTensors as :func:`attention`."""

    def layout(mesh):
        dp, hq, hkv, h0 = head_layout(mesh, qf.shape[0], n_heads, k.shape[2])
        cols = column_layout(mesh, n_heads, k.shape[-1])
        kv = P(dp, None, hkv, None)
        return ([P(dp, None, hq), kv, kv], P(dp, None, "model" if cols else hq),
                {"kv_from": h0 if hq is not None and hkv is None else None, "cols": cols})

    return local_region(functools.partial(_attend_local, attend=attend,
                                          rep=n_heads // k.shape[2]), (qf, k, v), layout)


def _attend_flat_local(qf, kf, vf, *, attend, head_dim: int, rep: int,
                       kv_from: int | None = None, cols: tuple | None = None,
                       gather: tuple | None = None):
    """:func:`_attend_local` over the flat K/V projections ``kf/vf [B, Sk,
    Hk·d]``.  With ``gather = (mesh, kv_split)`` (the column layout)
    ``qf`` — and ``kf/vf`` where ``kv_split`` — are this rank's columns:
    each is gathered over ``model`` and only the heads that cover ``cols``
    are kept."""
    if gather is None:
        k, v = (t.reshape(*t.shape[:-1], -1, head_dim) for t in (kf, vf))
        return _attend_local(qf, k, v, attend=attend, rep=rep, kv_from=kv_from, cols=cols)
    mesh, kv_split = gather
    qf, kv, off = _column_heads(gather_over(qf, mesh, "model", -1), cols, head_dim, rep)

    def heads(t):                 # the whole projection lives only until its heads are taken
        if kv_split:
            t = gather_over(t, mesh, "model", -1)
        return t.reshape(*t.shape[:-1], -1, head_dim).index_select(-2, kv)

    o = attend(qf.reshape(*qf.shape[:-1], -1, head_dim), heads(kf), heads(vf))
    return o.reshape(*o.shape[:-2], -1)[..., off:off + cols[1]]


def attend_flat(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, *, n_heads: int,
                n_kv_heads: int, head_dim: int, attend) -> torch.Tensor:
    """``attend`` of the flat queries ``qf [B, S, H·d]`` over the flat K/V
    projections ``kf/vf [B, Sk, Hk·d]`` → ``[B, S, H·d]``, laid out on
    DTensors as :func:`attend_heads`, but under the column layout
    (:func:`column_layout`) the queries, keys and values come as this
    rank's columns of their projections: each rank gathers them inside and
    keeps only the heads under its columns, one projection whole at a time."""

    def layout(mesh):
        dp, hq, hkv, h0 = head_layout(mesh, qf.shape[0], n_heads, n_kv_heads)
        cols = column_layout(mesh, n_heads, head_dim)
        if cols is not None:
            kv = split_axes(mesh, "model", kf.shape[-1])
            return ([P(dp, None, "model"), P(dp, None, kv), P(dp, None, kv)],
                    P(dp, None, "model"), {"cols": cols, "gather": (mesh, kv is not None)})
        kv = P(dp, None, hkv)
        return ([P(dp, None, hq), kv, kv], P(dp, None, hq),
                {"kv_from": h0 if hq is not None and hkv is None else None})

    return local_region(functools.partial(_attend_flat_local, attend=attend, head_dim=head_dim,
                                          rep=n_heads // n_kv_heads), (qf, kf, vf), layout)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full causal attention.  q [B,S,H,d], k/v [B,S,Hk,d] → [B,S,H,d].

    Masks with ``finfo.min`` and takes the softmax in fp32, as the reference.
    """
    b, s, h, d = q.shape
    hk = k.shape[2]
    kq = repeat_kv(k, h // hk)
    vq = repeat_kv(v, h // hk)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kq) / math.sqrt(d)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vq)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_start: int) -> torch.Tensor:
    """Causal attention for a *suffix chunk* of queries over the full keys.

    ``q [B,Sq,H,d]`` covers absolute positions ``[q_start, q_start+Sq)``;
    ``k/v [B,Sk,Hk,d]`` cover positions ``[0, Sk)`` (cached prefix KV
    concatenated with the chunk's own KV).  With ``q_start=0`` and
    ``Sq == Sk`` this is exactly :func:`causal_attention` — the chunked path
    computes the same score rows, so restoring bit-identical prefix KV makes
    warm prefill bit-identical to cold (``KVSwapEngine.prefill_cached``).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    hk = k.shape[2]
    kq = repeat_kv(k, h // hk)
    vq = repeat_kv(v, h // hk)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kq) / math.sqrt(d)
    # the [Sq, Sk] slice of the causal mask, built directly (an Sk×Sk tril
    # would be quadratic in the cached context for a short suffix)
    mask = ((q_start + torch.arange(sq, device=q.device))[:, None]
            >= torch.arange(sk, device=q.device)[None, :])
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vq)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder / cross attention.  q [B,Sq,H,d], k/v [B,Sk,Hk,d]; ``mask
    [B,Sk]`` (optional) keeps the keys it marks."""
    h, hk = q.shape[2], k.shape[2]
    kq = repeat_kv(k, h // hk)
    vq = repeat_kv(v, h // hk)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kq) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], torch.finfo(scores.dtype).min)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vq)


def decode_attention(q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                     ctx_mask: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> torch.Tensor:
    """One-token decode over an assembled (masked) context plus self.

    q [B,H,d]; k_ctx/v_ctx [B,N,Hk,d]; ctx_mask [B,N]; k_new/v_new [B,Hk,d].
    Returns [B,H,d].
    """
    b = q.shape[0]
    k_all = torch.cat([k_ctx, k_new[:, None]], dim=1)
    v_all = torch.cat([v_ctx, v_new[:, None]], dim=1)
    mask = torch.cat([ctx_mask, torch.ones((b, 1), dtype=torch.bool, device=q.device)], dim=1)
    return ops.gather_attention(q.contiguous(), k_all, v_all, mask).to(q.dtype)


def gather_slots(dev_k: torch.Tensor, dev_v: torch.Tensor, slots: torch.Tensor,
                 tail_k: torch.Tensor, tail_v: torch.Tensor,
                 tail_fill: torch.Tensor, planes: int = 2):
    """Assemble the decode context from persistent device buffers.

    ``dev_k/dev_v [B, C, G, H_kv, d]`` is the reuse buffer's device mirror;
    ``slots [B, M]`` the step's addressing: slot index where the group is
    resident, ``-1`` where the selection mask is off (clamped for the
    gather and turned into the token mask), ``-2`` for transiently staged
    groups (gathered wrong on purpose; the caller overwrites those rows).
    ``tail_k/tail_v [B, G, H_kv, d]`` is the device rolling tail and
    ``tail_fill [B]`` its per-row valid count.

    Returns ``(k_ctx, v_ctx, token_mask)`` with ``k_ctx [B, M·G + G, H_kv,
    d]`` — the layout the host-gather path builds, except that disabled
    slots hold stale finite data instead of zeros; their attention weight
    is exactly 0 either way, so both paths give bit-identical outputs.
    A cache of one plane (``planes`` 1, latent records: ``dev_v`` and
    ``tail_v`` are ignored) is gathered once and returned as both.
    """
    b, m = slots.shape
    c, g = dev_k.shape[1], dev_k.shape[2]
    idx = slots.clamp(0, c - 1)
    rows = torch.arange(b, device=slots.device)[:, None]
    tok_mask = torch.repeat_interleave(slots != -1, g, dim=1)            # [B, M·G]
    k_ctx = torch.cat([dev_k[rows, idx].reshape(b, m * g, *dev_k.shape[3:]),
                       tail_k.to(dev_k.dtype)], dim=1)
    v_ctx = k_ctx if planes == 1 else torch.cat(
        [dev_v[rows, idx].reshape(b, m * g, *dev_v.shape[3:]), tail_v.to(dev_v.dtype)], dim=1)
    tail_mask = torch.arange(g, device=slots.device)[None, :] < tail_fill[:, None]
    return k_ctx, v_ctx, torch.cat([tok_mask, tail_mask], dim=1)


def mla_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Causal attention over decompressed heads, ``chunk`` queries at a time
    (:func:`chunked_causal_attention` over the keys up to each chunk's
    end), so a long prompt's scores are never held whole.  ``q, k [B, S,
    H, d_qk]``, ``v [B, S, H, d_v]`` → ``[B, S, H, d_v]``."""
    s = q.shape[1]
    if s <= chunk:
        return causal_attention(q, k, v)
    return torch.cat([chunked_causal_attention(q[:, i:i + chunk], k[:, :i + chunk],
                                               v[:, :i + chunk], i)
                      for i in range(0, s, chunk)], dim=1)


# --------------------------------------------------------------------------
# multi-head latent attention (MLA, DeepSeek-V2/V3)
# --------------------------------------------------------------------------
#
# A layer caches one latent record a token, ``[RMSNorm(c_kv) ‖ RoPE(k_pe)]``
# (``kv_lora + rope`` floats, shared by every head); its heads' keys and
# values are decompressed from it through ``wkv_b``.  Params of an MLA
# block's ``attn``: ``wq_a [D, q_lora]``, ``q_norm``, ``wq_b [q_lora,
# H·(nope + rope)]``, ``wkv_a [D, kv_lora + rope]``, ``kv_norm``, ``wkv_b
# [kv_lora, H·(nope + v)]``, ``wo [H·v, D]``.


def init_mla(*, generator: torch.Generator, device, d_model: int, n_heads: int,
             q_lora: int, kv_lora: int, nope: int, rope: int, v_dim: int,
             dtype=torch.float32) -> dict:
    """MLA weights, dense ``N(0, 1/fan_in)``, norm scales 1."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda n: {"scale": torch.ones(n, device=device, dtype=dtype)}
    return {"wq_a": dense_init(d_model, q_lora, **kw), "q_norm": ones(q_lora),
            "wq_b": dense_init(q_lora, n_heads * (nope + rope), **kw),
            "wkv_a": dense_init(d_model, kv_lora + rope, **kw), "kv_norm": ones(kv_lora),
            "wkv_b": dense_init(kv_lora, n_heads * (nope + v_dim), **kw),
            "wo": dense_init(n_heads * v_dim, d_model, **kw)}


def mla_queries(p, h: torch.Tensor, positions: torch.Tensor, *, n_heads: int, nope: int,
                inv_freq: torch.Tensor) -> torch.Tensor:
    """``h [..., D]`` (normed) → ``q [..., H, nope + rope]``: ``[q_nope ‖
    RoPE(q_pe)]`` of ``RMSNorm(h wq_a) wq_b``."""
    q = rmsnorm(p["q_norm"], h @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(*q.shape[:-1], n_heads, -1)
    return torch.cat([q[..., :nope], apply_rope_interleaved(q[..., nope:], positions, inv_freq)],
                     dim=-1)


def mla_record(p, h: torch.Tensor, positions: torch.Tensor, *,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """``h [..., D]`` (normed) → the latent record ``[..., kv_lora + rope]``:
    ``[RMSNorm(c_kv) ‖ RoPE(k_pe)]`` of ``[c_kv ‖ k_pe] = h wkv_a``."""
    kv_lora = p["kv_norm"]["scale"].shape[0]
    kv = h @ p["wkv_a"]
    k_pe = apply_rope_interleaved(kv[..., None, kv_lora:], positions, inv_freq)[..., 0, :]
    return torch.cat([rmsnorm(p["kv_norm"], kv[..., :kv_lora]), k_pe], dim=-1)


def mla_expand(p, rec: torch.Tensor, *, n_heads: int, nope: int):
    """Latent records ``[..., kv_lora + rope]`` → each head's ``k [..., H,
    nope + rope]`` (``[c wkv_b's key part ‖ k_pe]``, ``k_pe`` shared by the
    heads) and ``v [..., H, v]``, contiguous."""
    kv_lora = p["kv_norm"]["scale"].shape[0]
    kv = (rec[..., :kv_lora] @ p["wkv_b"]).reshape(*rec.shape[:-1], n_heads, -1)
    k_pe = rec[..., None, kv_lora:].expand(*rec.shape[:-1], n_heads, rec.shape[-1] - kv_lora)
    return torch.cat([kv[..., :nope], k_pe], dim=-1), kv[..., nope:].contiguous()


def mla_absorbed_queries(p, q: torch.Tensor, *, nope: int) -> torch.Tensor:
    """Each head's query against the latent records: ``q [..., H, nope +
    rope]`` → ``[q_nope_h W_UK,hᵀ ‖ q_pe_h]`` ``[..., H, kv_lora + rope]``,
    ``W_UK,h`` head ``h``'s key part of ``wkv_b``, so that its product with
    a record is the head's exact logit before scaling."""
    kv_lora = p["kv_norm"]["scale"].shape[0]
    w_uk = p["wkv_b"].reshape(kv_lora, q.shape[-2], -1)[..., :nope]          # [R, H, nope]
    return torch.cat([torch.einsum("...hn,rhn->...hr", q[..., :nope], w_uk), q[..., nope:]],
                     dim=-1)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; on DTensors tensor-parallel over ``model`` (its output a
    partial sum there, :func:`linear_cols`, :func:`linear_rows`)."""
    return linear_rows(F.silu(linear_cols(x, p["w_gate"])) * linear_cols(x, p["w_up"]),
                       p["w_down"])


def init_gelu_mlp(*, generator: torch.Generator, device, d_model: int, d_ff: int,
                  dtype=torch.float32) -> dict:
    """GELU MLP weights in the reference layout: dense ``N(0, 1/fan_in)``,
    biases 0."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"w_up": dense_init(d_model, d_ff, **kw),
            "b_up": torch.zeros(d_ff, device=device, dtype=dtype),
            "w_down": dense_init(d_ff, d_model, **kw),
            "b_down": torch.zeros(d_model, device=device, dtype=dtype)}


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, so is this one's.
    On DTensors tensor-parallel over ``model``, as :func:`swiglu`."""
    h = F.gelu(linear_cols(x, p["w_up"]) + p["b_up"], approximate="tanh")
    return linear_rows(h, p["w_down"]) + p["b_down"]


# --------------------------------------------------------------------------
# MoE (top-k routing, capacity-bounded dispatch)
# --------------------------------------------------------------------------


# Optional sharding of the MoE dispatch, set by a launcher that runs the model
# on DTensor params: ``{"buf": ..., "y": ...}``, as the reference's.  With
# ``buf`` set, the dispatch, the experts and the combine run as three
# regions, and ``buf`` lays out the dispatch buffer between the first two
# and the experts' output between the last two (the dry run's ``P(dp, None,
# None, None)``: every expert whole on every rank, gathered once, so the
# combine needs no sum over ``model``); ``y`` pins the routed output.
# Unset, the routed experts run as one region whose output is a partial sum
# over ``model``.  On plain tensors the hook does nothing.
_MOE_PSPECS: dict | None = None


def set_moe_pspecs(specs: dict | None) -> None:
    global _MOE_PSPECS
    _MOE_PSPECS = specs


def _moe_constrain(name: str, x: torch.Tensor) -> torch.Tensor:
    if _MOE_PSPECS is None or name not in _MOE_PSPECS:
        return x
    return constrain(x, _MOE_PSPECS[name])


def init_moe(*, generator: torch.Generator, device, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32, shared_d_ff: int = 0,
             n_held: int = 0) -> dict:
    """MoE weights in the reference layout, drawn from ``generator``: the
    router ``N(0, 0.02²)``, the experts' gate and up ``N(0, 1/d_model)`` and
    down ``N(0, 1/d_ff)``, and an optional dense shared expert.  With
    ``n_held`` the router keeps its ``n_experts`` outputs and only the first
    ``n_held`` experts are drawn (this device's share of an expert-parallel
    layer)."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)

    el = n_held or n_experts
    p = {
        "router": normal((d_model, n_experts), 0.02),
        "w_gate": normal((el, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w_up": normal((el, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w_down": normal((el, d_ff, d_model), 1.0 / math.sqrt(d_ff)),
    }
    if shared_d_ff:
        p["shared"] = {"w_gate": normal((d_model, shared_d_ff), 1.0 / math.sqrt(d_model)),
                       "w_up": normal((d_model, shared_d_ff), 1.0 / math.sqrt(d_model)),
                       "w_down": normal((shared_d_ff, d_model), 1.0 / math.sqrt(shared_d_ff))}
    return p


def moe_capacity(s: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert in one row's dispatch buffer for a call of ``s``
    tokens: ``ceil(s·k / E · cf)``, at least 1 (1 for a decode step)."""
    return max(1, int(np.ceil(s * top_k / n_experts * capacity_factor)))


ROUTER_SCORES = {"softmax": lambda logits: torch.softmax(logits, dim=-1),
                 "sigmoid": torch.sigmoid}


def moe(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
        score: str = "softmax"):
    """Top-k routed MoE with capacity-bounded dispatch, as the reference.

    ``x: [B, S, D]`` → ``(y [B, S, D], aux_loss scalar)``.  Each row's
    ``S·k`` assignments, token-major then by rank, queue at their expert in
    that order (an exclusive cumsum); those at or past the capacity
    (:func:`moe_capacity`) are dropped.  The kept ones are scattered into a
    per-row buffer ``[B, E, C, D]``, the expert SwiGLU runs batched over
    ``E`` (every expert, whatever the number of tokens it holds), and the
    outputs come back weighted by their renormalised gates.  The top k are
    taken by a stable descending sort, so equal probabilities rank the lower
    expert first, as ``jax.lax.top_k`` does.  ``aux_loss`` is the Switch
    load-balance loss.  ``score`` names the router's scores
    (:data:`ROUTER_SCORES`: a softmax over the experts, or DeepSeek-V3's
    independent sigmoids); the gates are the chosen scores over their sum.
    A ``capacity_factor`` of 0 or less is dropless: the capacity is the
    most assignments any expert computed here takes in the call.

    Plain ``w_gate/w_up/w_down`` that hold fewer experts than the router
    routes over (``El < E``) are this device's share of an expert-parallel
    layer, experts ``[0, El)``: every token is routed over all ``E``, and
    ``y`` is the part of the output those experts give (the shared expert
    whole).

    On DTensors the routing, dispatch and combine run on each rank's shard
    (:func:`~repro_torch.sharding.partition.local_region`): a rank routes
    its batch rows over every expert and runs only its own experts (the
    expert axis of ``w_gate/w_up/w_down`` lies over ``model``).  Without the
    ``buf`` hook (:func:`set_moe_pspecs`) one region returns each rank's
    share of ``y`` as a partial sum over ``model``; with it the experts'
    outputs are laid out by the hook before the combine.  For a few tokens
    (:func:`moves_activations`) experts split over ``data`` (FSDP) stay
    where they are: the rows come whole, each rank multiplies its slice of
    ``D`` and of ``F``, and the partial products are summed over ``data``.
    The means of the load-balance loss come back as partial sums of each
    rank's share.
    """
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, score=score)
    if _MOE_PSPECS is not None and "buf" in _MOE_PSPECS and mesh_of(x) is not None:
        y, me, ce = _moe_three_regions(p, x, **kw)
    else:
        y, me, ce = _moe_one_region(p, x, **kw)
    y = _moe_constrain("y", y)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    aux = p["router"].shape[1] * torch.sum(me * ce)
    return y, aux


def _moe_stats(mesh, *axes):
    """The loss statistics' placements and ``shares``: each rank's 1/n
    share of their means, summed over the axes that split the work (a
    partial sum, not a partial mean: DTensor passes a partial output's
    gradient to each rank whole).  ``axes``: names, tuples of them or
    ``None``."""
    names = tuple(n for a in axes if a for n in ((a,) if isinstance(a, str) else a))
    return partial_placements(mesh, P(), names), axis_size(mesh, names)


def _moe_one_region(p, x: torch.Tensor, *, top_k: int, capacity_factor: float, score: str):
    e = p["router"].shape[1]
    w_gate = p["w_gate"]

    def layout(mesh):
        ex = split_axes(mesh, "model", e)
        el, (d, f) = e // axis_size(mesh, ex), w_gate.shape[1:]
        fsdp = moves_activations(mesh, x.numel() // d * top_k, w_gate, 1,
                                 2 * f + d // axis_size(mesh, "data"))
        dp = None if fsdp else split_axes(mesh, batch_axes(mesh), x.shape[0])
        w = P(ex, "data" if fsdp else None, None)
        # with the rows whole (fsdp) every rank of ``data`` routes all of them
        stat, shares = _moe_stats(mesh, dp, ex, "data" if fsdp else None)
        kw = {"e0": axis_index(mesh, ex) * el, "shares": shares}
        if fsdp:
            kw["fsdp"] = (mesh, axis_index(mesh, "data"), axis_size(mesh, "data"))
        return ([P(), w, w, w, P(dp, None, None)],
                [partial_placements(mesh, P(dp, None, None), (ex, "data") if fsdp else ex),
                 stat, stat], kw)

    return local_region(
        functools.partial(_moe_routed, top_k=top_k, capacity_factor=capacity_factor,
                          score=score),
        (p["router"], w_gate, p["w_up"], p["w_down"], x), layout)


def _moe_three_regions(p, x: torch.Tensor, *, top_k: int, capacity_factor: float, score: str):
    """:func:`moe`'s routed experts as dispatch, experts and combine, each
    on each rank's shard, with the ``buf`` hook's layout between them."""
    e = p["router"].shape[1]

    def dispatch_layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), x.shape[0])
        rows = P(dp, None)
        stat, shares = _moe_stats(mesh, dp)
        return ([P(), P(dp, None, None)],
                [P(dp, None, None, None), rows, rows, rows, rows, stat, stat],
                {"shares": shares})

    buf, expert_of, pos_safe, gates, keep, me, ce = local_region(
        functools.partial(_moe_dispatch, top_k=top_k, capacity_factor=capacity_factor,
                          score=score),
        (p["router"], x), dispatch_layout)
    buf = _moe_constrain("buf", buf)                      # [B(data), E, C, D]

    def expert_layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), buf.shape[0])
        ex = split_axes(mesh, "model", e)
        w = P(ex, None, None)
        return [P(dp, ex, None, None), w, w, w], P(dp, ex, None, None), {}

    out = local_region(_moe_experts, (buf, p["w_gate"], p["w_up"], p["w_down"]), expert_layout)
    out = _moe_constrain("buf", out)

    def combine_layout(mesh):
        dp = split_axes(mesh, batch_axes(mesh), x.shape[0])
        rows = P(dp, None)
        return [P(dp, None, None, None), rows, rows, rows, rows], P(dp, None, None), {}

    y = local_region(functools.partial(_moe_combine, top_k=top_k),
                     (out, expert_of, pos_safe, gates, keep), combine_layout)
    return y, me, ce


def _moe_dispatch(router, x: torch.Tensor, *, top_k: int, capacity_factor: float,
                  shares: int = 1, score: str = "softmax", held: tuple | None = None):
    """Routing and dispatch of :func:`moe` → ``(buf [B, E, C, D], expert_of,
    pos_safe, gates, keep [B, S·k], me [E], ce [E])``: the buffer of every
    expert, each assignment's expert, slot (``C`` where dropped), gate and
    whether it is kept, and the mean router score and routed fraction of
    each expert over the rows (this rank's share of them).  With ``held =
    (e0, El)`` the buffer holds only experts ``[e0, e0 + El)`` (``[B, El, C,
    D]``), and every other expert's assignments take slot ``C``."""
    b, s, d = x.shape
    e = router.shape[1]
    probs = ROUTER_SCORES[score]((x @ router).float())                    # [B,S,E]
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]    # [B,S,K]
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)

    e0, el = held if held is not None else (0, e)
    t = s * top_k                                          # assignments per row
    expert_of = gate_idx.reshape(b, t)                     # [B,T]
    token_of = torch.arange(s, device=x.device).repeat_interleave(top_k)[None].expand(b, t)
    gates = gate_vals.reshape(b, t)

    # position of each assignment within its expert's queue
    assign = F.one_hot(expert_of, e)                                   # [B,T,E]
    pos = (assign.cumsum(dim=1) - assign).gather(-1, expert_of[..., None])[..., 0]
    if capacity_factor > 0:
        cap = moe_capacity(s, top_k, e, capacity_factor)
    else:   # dropless: a decode step's token takes an expert at most once
        cap = 1 if s == 1 else max(1, int(assign[..., e0:e0 + el].sum(dim=1).max()))
    keep = pos < cap
    slot = keep if held is None else keep & (expert_of >= e0) & (expert_of < e0 + el)
    pos_safe = torch.where(slot, pos, cap)                 # slot cap = dropped

    # one scatter with no mask (a boolean index would wait on the host):
    # dropped assignments land in an extra slot that is sliced away
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, t)
    buf = x.new_zeros((b, el, cap + 1, d))
    local = expert_of if held is None else (expert_of - e0).clamp(0, el - 1)
    buf.index_put_((bidx, local, pos_safe), x[bidx, token_of])

    me = probs.mean(dim=(0, 1))                                         # [E]
    ce = F.one_hot(gate_idx, e).sum(dim=2).float().mean(dim=(0, 1))     # routed fraction
    if shares > 1:                # this rank's share of statistics every rank computes
        me, ce = me / shares, ce / shares
    return buf[:, :, :cap], expert_of, pos_safe, gates, keep, me, ce


def _moe_experts(buf, w_gate, w_up, w_down, *, fsdp: tuple | None = None):
    """The expert SwiGLU over ``buf [B, El, C, D]`` with the experts'
    weights ``[El, ...]``.  With ``fsdp = (mesh, i, n)`` the weights hold
    slice ``i`` of ``n`` of ``D`` (gate, up) and of ``F`` (down): the gate
    and up products are summed over ``data``, the output is this rank's
    partial sum."""
    if fsdp is not None:
        mesh, i, n = fsdp
        dl = buf.shape[-1] // n
        bd = buf[..., i * dl:(i + 1) * dl]
        h = F.silu(sum_over(torch.einsum("becd,edf->becf", bd, w_gate), mesh, "data"))
        h = h * sum_over(torch.einsum("becd,edf->becf", bd, w_up), mesh, "data")
        fl = h.shape[-1] // n
        return torch.einsum("becf,efd->becd", h[..., i * fl:(i + 1) * fl], w_down)
    h = F.silu(torch.einsum("becd,edf->becf", buf, w_gate))
    h = h * torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", h, w_down)                  # [B,El,C,D]


def _moe_combine(out, expert_of, pos_safe, gates, keep, *, top_k: int, e0: int | None = None):
    """Each assignment's expert output from ``out [B, El, C, D]``, weighted
    by its gate, summed over each token's ``k`` → ``y [B, S, D]``.  With
    ``e0``, ``out`` holds the experts ``[e0, e0 + El)`` only, and the others'
    assignments give 0."""
    b, t = expert_of.shape
    el, cap, d = out.shape[1:]
    bidx = torch.arange(b, device=out.device)[:, None].expand(b, t)
    if e0 is not None:
        mine = (expert_of >= e0) & (expert_of < e0 + el)
        y_tok = out[bidx, (expert_of - e0).clamp(0, el - 1), pos_safe.clamp(0, cap - 1)]
        y_tok = y_tok * (gates * keep * mine).to(y_tok.dtype)[..., None]
    else:
        y_tok = out[bidx, expert_of, pos_safe.clamp(0, cap - 1)]            # [B,T,D]
        y_tok = y_tok * (gates * keep).to(y_tok.dtype)[..., None]
    # each token's k assignments are adjacent: sum them (the reference's
    # scatter-add onto the token, in a fixed order)
    return y_tok.reshape(b, t // top_k, top_k, d).sum(dim=2)


def _moe_routed(router, w_gate, w_up, w_down, x: torch.Tensor, *, top_k: int,
                capacity_factor: float, score: str = "softmax", e0: int = 0, shares: int = 1,
                fsdp: tuple | None = None):
    """The routed experts of :func:`moe` over the experts ``[e0, e0 + El)``
    that ``w_gate/w_up/w_down [El, ...]`` hold (all of them by default) →
    ``(y [B, S, D], me [E], ce [E])``: ``y`` those experts' share of the
    output, ``me`` and ``ce`` the mean router score and the routed
    fraction of each expert over the rows."""
    e, el = router.shape[1], w_gate.shape[0]
    held = (e0, el) if el < e else None                    # this rank's experts
    buf, expert_of, pos_safe, gates, keep, me, ce = _moe_dispatch(
        router, x, top_k=top_k, capacity_factor=capacity_factor, shares=shares, score=score,
        held=held)
    out = _moe_experts(buf, w_gate, w_up, w_down, fsdp=fsdp)
    y = _moe_combine(out, expert_of, pos_safe, gates, keep, top_k=top_k,
                     e0=e0 if held is not None else None)
    return y, me, ce
