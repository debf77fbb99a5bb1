"""Shared building blocks of the attention path: norms (RMS and layer norm),
RoPE, GQA attention (causal, chunked, bidirectional and one-token decode),
SwiGLU, the GELU MLP and top-k routed MoE — the PyTorch port of
:mod:`repro.models.layers` (the reference's MoE sharding annotations belong
to the distributed slice and are not here).

Plain functions on tensors; params are plain dicts of tensors with the
reference's layout (weights ``[in, out]``, applied as ``x @ w``).  Decode
attention goes through :func:`repro_torch.kernels.ops.gather_attention`,
which launches the CUDA flash-decode kernel for a CUDA tensor and runs its
plain version for a CPU tensor — there is no module-level switch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------


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
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., Hk, d] -> [..., Hk*n_rep, d]"""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


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
                 tail_fill: torch.Tensor):
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
    """
    b, m = slots.shape
    c, g = dev_k.shape[1], dev_k.shape[2]
    idx = slots.clamp(0, c - 1)
    rows = torch.arange(b, device=slots.device)[:, None]
    k_ctx = dev_k[rows, idx].reshape(b, m * g, *dev_k.shape[3:])
    v_ctx = dev_v[rows, idx].reshape(b, m * g, *dev_v.shape[3:])
    tok_mask = torch.repeat_interleave(slots != -1, g, dim=1)            # [B, M·G]
    k_ctx = torch.cat([k_ctx, tail_k.to(dev_k.dtype)], dim=1)
    v_ctx = torch.cat([v_ctx, tail_v.to(dev_v.dtype)], dim=1)
    tail_mask = torch.arange(g, device=slots.device)[None, :] < tail_fill[:, None]
    return k_ctx, v_ctx, torch.cat([tok_mask, tail_mask], dim=1)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


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
    """``jax.nn.gelu``'s default is the tanh approximation, so is this one's."""
    return F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh") @ p["w_down"] + p["b_down"]


# --------------------------------------------------------------------------
# MoE (top-k routing, capacity-bounded dispatch)
# --------------------------------------------------------------------------


def init_moe(*, generator: torch.Generator, device, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32, shared_d_ff: int = 0) -> dict:
    """MoE weights in the reference layout, drawn from ``generator``: the
    router ``N(0, 0.02²)``, the experts' gate and up ``N(0, 1/d_model)`` and
    down ``N(0, 1/d_ff)``, and an optional dense shared expert."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)

    p = {
        "router": normal((d_model, n_experts), 0.02),
        "w_gate": normal((n_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w_up": normal((n_experts, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w_down": normal((n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff)),
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


def moe(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
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
    load-balance loss.
    """
    b, s, d = x.shape
    e = p["router"].shape[1]
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)               # [B,S,E]
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]    # [B,S,K]
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)

    cap = moe_capacity(s, top_k, e, capacity_factor)
    t = s * top_k                                          # assignments per row
    expert_of = gate_idx.reshape(b, t)                     # [B,T]
    token_of = torch.arange(s, device=x.device).repeat_interleave(top_k)[None].expand(b, t)
    gates = gate_vals.reshape(b, t)

    # position of each assignment within its expert's queue
    assign = F.one_hot(expert_of, e)                                   # [B,T,E]
    pos = (assign.cumsum(dim=1) - assign).gather(-1, expert_of[..., None])[..., 0]
    keep = pos < cap
    pos_safe = torch.where(keep, pos, cap)                 # slot cap = dropped

    # one scatter with no mask (a boolean index would wait on the host):
    # dropped assignments land in an extra slot that is sliced away
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, t)
    buf = x.new_zeros((b, e, cap + 1, d))
    buf.index_put_((bidx, expert_of, pos_safe), x[bidx, token_of])
    buf = buf[:, :, :cap]

    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", h, p["w_down"])                # [B,E,C,D]

    y_tok = out[bidx, expert_of, pos_safe.clamp(0, cap - 1)]            # [B,T,D]
    y_tok = y_tok * (gates * keep).to(y_tok.dtype)[..., None]
    # each token's k assignments are adjacent: sum them (the reference's
    # scatter-add onto the token, in a fixed order)
    y = y_tok.reshape(b, s, top_k, d).sum(dim=2)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)

    me = probs.mean(dim=(0, 1))                                         # [E]
    ce = F.one_hot(gate_idx, e).sum(dim=2).float().mean(dim=(0, 1))     # routed fraction
    aux = e * torch.sum(me * ce)
    return y, aux
