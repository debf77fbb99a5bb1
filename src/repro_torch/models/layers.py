"""Shared building blocks of the attention path: norms, RoPE, GQA attention,
SwiGLU — the PyTorch port of :mod:`repro.models.layers` (attention and
dense MLP only).

Plain functions on tensors; params are plain dicts of tensors with the
reference's layout (weights ``[in, out]``, applied as ``x @ w``).  Decode
attention goes through :func:`repro_torch.kernels.ops.gather_attention`,
which launches the CUDA flash-decode kernel for a CUDA tensor and runs its
plain version for a CPU tensor — there is no module-level switch.
"""

from __future__ import annotations

import math

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
