"""Decoder stack for the port's dense attention models.

:class:`ModelConfig` is the reference's config record, copied; the params
are a plain dict of tensors with the reference ``init_params`` layout (so
:mod:`repro_torch.bridge` can load the reference's weights one to one), and
:class:`TransformerAdapter` is the per-block prefill/decode interface the
KVSwap engine consumes.  This slice builds ``"attn"`` blocks only; every
other block kind (MoE, shared attention, Mamba2, xLSTM) raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L

ATTN_KINDS = ("attn", "moe_attn", "shared_attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple = ()      # per-layer kinds; default: all "attn"
    qk_norm: bool = False
    rope_theta: float = 500000.0
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_use_pallas: bool = False   # route Mamba2 intra-chunk through Pallas
    tie_embeddings: bool = True
    source: str = ""               # citation for the config

    @property
    def blocks(self) -> tuple:
        return self.block_pattern or ("attn",) * self.n_layers

    @property
    def kv_layers(self) -> tuple:
        return tuple(i for i, k in enumerate(self.blocks) if k in ATTN_KINDS)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d                       # embed (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.blocks:
            if kind in ("attn", "moe_attn"):
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
                if kind == "attn":
                    n += 3 * d * self.d_ff
                else:
                    n += d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff
                    n += 3 * d * self.moe_shared_d_ff
            elif kind == "shared_attn":
                pass  # weights shared; counted once below
            elif kind == "mamba2":
                di = self.ssm_expand * d
                n += d * (2 * di + 2 * self.ssm_state + di // 64) + di * d
            elif kind in ("mlstm", "slstm"):
                n += 4 * d * d if kind == "mlstm" else 8 * d * d + d * d
        if "shared_attn" in self.blocks:
            n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for k in self.blocks if k == "moe_attn")
        all_exp = moe_layers * 3 * self.n_experts * self.d_model * self.moe_d_ff
        act_exp = moe_layers * 3 * self.moe_top_k * self.d_model * self.moe_d_ff
        return full - all_exp + act_exp


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _normal(shape, scale: float, *, generator, device, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(scale)


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random weights in the reference layout, drawn from ``generator``
    (which must live on ``device``).  Dense matrices are ``N(0, 1/fan_in)``
    and the embedding ``N(0, 0.02²)``, as the reference draws them; the
    draws themselves differ from JAX's (load the reference's weights with
    :func:`repro_torch.bridge.params_from_numpy` to compare)."""
    dev = resolve(device)
    kw = dict(generator=generator, device=dev, dtype=dtype)

    def dense(fan_in: int, fan_out: int) -> torch.Tensor:
        return _normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in), **kw)

    def norm(dim: int) -> dict:
        return {"scale": torch.ones(dim, device=dev, dtype=dtype)}

    d, hd = cfg.d_model, cfg.head_dim
    blocks = []
    for kind in cfg.blocks:
        if kind != "attn":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (dense 'attn' blocks only)")
        attn = {"wq": dense(d, cfg.n_heads * hd), "wk": dense(d, cfg.n_kv_heads * hd),
                "wv": dense(d, cfg.n_kv_heads * hd), "wo": dense(cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = norm(hd), norm(hd)
        blocks.append({
            "attn_norm": norm(d),
            "attn": attn,
            "mlp_norm": norm(d),
            "mlp": {"w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
                    "w_down": dense(cfg.d_ff, d)},
        })
    params = {
        "embed": _normal((cfg.vocab_size, d), 0.02, **kw),
        "blocks": blocks,
        "final_norm": norm(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    return params


# --------------------------------------------------------------------------
# engine adapter
# --------------------------------------------------------------------------


class TransformerAdapter:
    """Implements :class:`repro_torch.core.adapter.ModelAdapter` for dense
    attention stacks."""

    def __init__(self, cfg: ModelConfig):
        bad = [k for k in cfg.blocks if k != "attn"]
        if bad:
            raise NotImplementedError(
                f"block kinds {sorted(set(bad))} are not ported yet "
                "(dense 'attn' blocks only)")
        self.cfg = cfg
        self.n_layers = len(cfg.blocks)
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = cfg.head_dim
        self.d_model = cfg.d_model
        self.d_ff = cfg.d_ff or 4 * cfg.d_model
        self.vocab_size = cfg.vocab_size
        self.layer_kinds = ("kv",) * self.n_layers

    def _qkv(self, attn_p, h, positions):
        cfg = self.cfg
        return L.attention_qkv(attn_p, h, positions, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                               rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)

    # -- embedding / head -------------------------------------------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x)
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ head

    # -- prefill -----------------------------------------------------------
    def prefill_block(self, params, layer: int, x: torch.Tensor, positions: torch.Tensor):
        """Full-attention prefill through block ``layer``: ``x [B, S, D]`` →
        ``(x_out, k [B, S, H_kv, d], v)`` with K post-RoPE (what gets cached)."""
        blk = params["blocks"][layer]
        h = L.rmsnorm(blk["attn_norm"], x)
        q, k, v = self._qkv(blk["attn"], h, positions)
        o = L.causal_attention(q, k, v)
        x = x + o.reshape(*x.shape[:-1], self.n_heads * self.head_dim) @ blk["attn"]["wo"]
        x = x + L.swiglu(blk["mlp"], L.rmsnorm(blk["mlp_norm"], x))
        return x, k, v

    # -- decode ------------------------------------------------------------
    def gather_context(self, dev_k, dev_v, slots, tail_k, tail_v, tail_fill):
        """Device-resident context assembly (engine ``device_resident=True``):
        the step's working set gathered out of the device reuse mirror by
        slot permutation plus the device rolling tail, as the same ``(k_ctx,
        v_ctx, ctx_mask)`` triple :meth:`decode_block` takes on the
        host-gather path."""
        return L.gather_slots(dev_k, dev_v, slots, tail_k, tail_v, tail_fill)

    def decode_block(self, params, layer: int, x, positions, k_ctx, v_ctx, ctx_mask):
        """One-token decode: ``x [B, D]`` at ``positions [B]`` attending to the
        assembled context plus itself → ``(x_out, k_new [B, H_kv, d], v_new)``."""
        blk = params["blocks"][layer]
        h = L.rmsnorm(blk["attn_norm"], x)
        q, k_new, v_new = self._qkv(blk["attn"], h[:, None], positions[:, None])
        q, k_new, v_new = q[:, 0], k_new[:, 0], v_new[:, 0]
        o = L.decode_attention(q, k_ctx, v_ctx, ctx_mask, k_new, v_new)
        x = x + o.reshape(x.shape[0], self.n_heads * self.head_dim) @ blk["attn"]["wo"]
        x = x + L.swiglu(blk["mlp"], L.rmsnorm(blk["mlp_norm"], x))
        return x, k_new, v_new

    # -- predictor ---------------------------------------------------------
    def predict_query(self, params, layer: int, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """Layer ``layer``'s query (input norm, Q projection, qk-norm, RoPE)
        from a possibly approximate input ``x [B, D]`` → ``[B, H, d]``."""
        cfg = self.cfg
        attn_p = params["blocks"][layer]["attn"]
        h = L.rmsnorm(params["blocks"][layer]["attn_norm"], x)
        q = (h @ attn_p["wq"]).reshape(x.shape[0], cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rmsnorm(attn_p["q_norm"], q)
        return L.apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
