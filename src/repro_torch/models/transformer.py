"""Decoder stack of the port: dense attention, MoE attention blocks, the
Zamba2-style hybrid of Mamba2 blocks with shared-weight attention, and the
attention-free xLSTM stack of mLSTM and sLSTM blocks.

:class:`ModelConfig` is the reference's config record, copied; the params
are a plain dict of tensors with the reference ``init_params`` layout (so
:mod:`repro_torch.bridge` can load the reference's weights one to one),
``forward`` is the teacher-forced full-sequence forward (logits and the
MoE load-balance loss, as the reference returns them), and
:class:`TransformerAdapter` is the per-block prefill/decode interface the
KVSwap engine consumes.  It builds every block kind of the reference:
``"attn"``, ``"moe_attn"``, ``"shared_attn"``, ``"mamba2"``, ``"mlstm"`` and
``"slstm"``, and one of its own: ``"mla_moe"``, multi-head latent attention
(DeepSeek-V2/V3's MLA, YaRN RoPE on interleaved pairs) with routed experts,
whose KV layer caches one latent record a token in place of a K/V pair.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.sharding.partition import constrain, like, rows

ATTN_KINDS = ("attn", "moe_attn", "shared_attn", "mla_moe")
MOE_KINDS = ("moe_attn", "mla_moe")

# Optional between-block activation spec (sequence parallelism), set by a
# launcher that runs the model on DTensor params: an attention block's output
# is redistributed to it.  Unset, or on a plain tensor, it does nothing.
_ACT_PSPEC = None


def set_activation_pspec(spec) -> None:
    """``spec``: a :class:`repro_torch.sharding.P` over the mesh the params
    live on, or ``None`` to unset."""
    global _ACT_PSPEC
    _ACT_PSPEC = spec


def _act_constrain(x: torch.Tensor) -> torch.Tensor:
    if _ACT_PSPEC is None or x.dim() != 3:
        return x
    return constrain(x, _ACT_PSPEC)


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's rope scaling (DeepSeek-V3's ``rope_scaling`` of type ``yarn``),
    with ``mscale == mscale_all_dim``, so that cos and sin are unscaled."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 1.0

    @property
    def softmax_factor(self) -> float:
        """``m²``, ``m = 0.1·mscale_all_dim·ln(factor) + 1``: what the
        attention's ``1/sqrt(d)`` is multiplied by."""
        return (0.1 * self.mscale_all_dim * math.log(self.factor) + 1.0) ** 2


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
    # MoE: the router's scores ("softmax" | "sigmoid") and the experts held
    # here (0: all n_experts; else experts [0, held) of an expert-parallel layer)
    moe_router: str = "softmax"
    moe_experts_held: int = 0
    # multi-head latent attention ("mla_moe" blocks, YaRN RoPE); n_heads, and
    # head_dim = nope + rope for the decompressed heads
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    yarn: Yarn | None = None

    @property
    def blocks(self) -> tuple:
        return self.block_pattern or ("attn",) * self.n_layers

    @property
    def kv_layers(self) -> tuple:
        return tuple(i for i, k in enumerate(self.blocks) if k in ATTN_KINDS)

    @property
    def latent(self) -> bool:
        """Whether the KV layers cache MLA's latent records."""
        return "mla_moe" in self.blocks

    @property
    def record_dim(self) -> int:
        """Floats of one cached latent record: ``kv_lora + rope``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def max_positions(self) -> int | None:
        """The positions the config defines: YaRN's original context, past
        which Mistral-Small-4's query scaling (``llama_4_scaling_beta``,
        exactly 1 below it) is not applied here."""
        return self.yarn.original_max_position if self.yarn else None

    def rope_inv_freq(self, device=None) -> torch.Tensor:
        """The rotary frequencies of an MLA block's ``qk_rope_head_dim``."""
        return L.yarn_inv_freq(self.qk_rope_head_dim, self.rope_theta, self.yarn, device)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d                       # embed (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.blocks:
            if kind == "mla_moe":
                h = self.n_heads
                n += (d * self.q_lora_rank + self.q_lora_rank * h * hd
                      + d * self.record_dim + self.kv_lora_rank * h * (
                          self.qk_nope_head_dim + self.v_head_dim) + h * self.v_head_dim * d)
                n += d * self.n_experts + 3 * d * self.moe_shared_d_ff
                n += 3 * (self.moe_experts_held or self.n_experts) * d * self.moe_d_ff
            elif kind in ("attn", "moe_attn"):
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
        moe_layers = sum(1 for k in self.blocks if k in MOE_KINDS)
        held = self.moe_experts_held or self.n_experts
        all_exp = moe_layers * 3 * held * self.d_model * self.moe_d_ff
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

    def attention() -> dict:
        attn = L.init_attention(generator=generator, device=dev, d_model=d, n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads, head_dim=hd, dtype=dtype)
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = norm(hd), norm(hd)
        return attn

    def mlp() -> dict:
        return {"w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
                "w_down": dense(cfg.d_ff, d)}

    blocks = []
    for kind in cfg.blocks:
        if kind == "attn":
            blocks.append({"attn_norm": norm(d), "attn": attention(),
                           "mlp_norm": norm(d), "mlp": mlp()})
        elif kind in MOE_KINDS:
            attn = attention() if kind == "moe_attn" else L.init_mla(
                generator=generator, device=dev, d_model=d, n_heads=cfg.n_heads,
                q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank, nope=cfg.qk_nope_head_dim,
                rope=cfg.qk_rope_head_dim, v_dim=cfg.v_head_dim, dtype=dtype)
            blocks.append({"attn_norm": norm(d), "attn": attn, "mlp_norm": norm(d),
                           "moe": L.init_moe(generator=generator, device=dev, d_model=d,
                                             d_ff=cfg.moe_d_ff, n_experts=cfg.n_experts,
                                             dtype=dtype, shared_d_ff=cfg.moe_shared_d_ff,
                                             n_held=cfg.moe_experts_held)})
        elif kind == "shared_attn":
            # per-block input norm; the attention and MLP weights are shared
            blocks.append({"attn_norm": norm(d)})
        elif kind == "mamba2":
            blocks.append({"norm": norm(d),
                           "mamba": S.init_mamba2(generator=generator, device=dev,
                                                  d_model=d, d_state=cfg.ssm_state,
                                                  expand=cfg.ssm_expand, dtype=dtype)})
        elif kind in ("mlstm", "slstm"):
            init = S.init_mlstm if kind == "mlstm" else S.init_slstm
            blocks.append({"norm": norm(d),
                           kind: init(generator=generator, device=dev, d_model=d,
                                      n_heads=cfg.n_heads, dtype=dtype)})
        else:
            raise ValueError(f"unknown block kind {kind}")
    params = {
        "embed": _normal((cfg.vocab_size, d), 0.02, **kw),
        "blocks": blocks,
        "final_norm": norm(d),
    }
    if "shared_attn" in cfg.blocks:
        params["shared_attn"] = {"attn": attention(), "mlp_norm": norm(d), "mlp": mlp()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    return params


# --------------------------------------------------------------------------
# full-sequence forward (teacher-forced reference, prefill)
# --------------------------------------------------------------------------


def _attn_params(params, cfg: ModelConfig, layer: int):
    """``(norm holder, attention weights, MLP holder)`` of an attention
    block: a ``shared_attn`` block keeps only its input norm and uses the
    shared attention and MLP weights."""
    blk = params["blocks"][layer]
    if cfg.blocks[layer] == "shared_attn":
        return blk, params["shared_attn"]["attn"], params["shared_attn"]
    return blk, blk["attn"], blk


def _qkv(cfg: ModelConfig, attn_p, h, positions):
    return L.attention_qkv(attn_p, h, positions, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                           rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)


def _ffn(params, cfg: ModelConfig, layer: int, mlp_holder, h: torch.Tensor):
    """The block's feed-forward on the normed ``h [B, S, D]`` → ``(y,
    aux)``: routed MoE (with its load-balance loss) in a ``moe_attn`` or
    ``mla_moe`` block, else the dense SwiGLU (aux 0)."""
    if cfg.blocks[layer] in MOE_KINDS:
        return L.moe(params["blocks"][layer]["moe"], h, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor, score=cfg.moe_router)
    return L.swiglu(mlp_holder["mlp"], h), 0.0


def _mla_q(cfg: ModelConfig, attn_p, h: torch.Tensor, positions: torch.Tensor,
           inv_freq: torch.Tensor) -> torch.Tensor:
    """An MLA block's queries ``[..., H, nope + rope]``, scaled by YaRN's
    ``m²`` so that an attention dividing by ``sqrt(nope + rope)`` takes the
    model's softmax scale."""
    q = L.mla_queries(attn_p, h, positions, n_heads=cfg.n_heads, nope=cfg.qk_nope_head_dim,
                      inv_freq=inv_freq)
    return q * cfg.yarn.softmax_factor


def _mla_forward(params, cfg: ModelConfig, layer: int, x: torch.Tensor,
                 positions: torch.Tensor):
    """Full-sequence MLA block: ``x [B, S, D]`` → ``(x, aux, record [B, S,
    1, kv_lora + rope])``, the latent records as the KV layer caches them."""
    if cfg.max_positions is not None and x.shape[1] > cfg.max_positions:
        raise ValueError(f"{x.shape[1]} positions exceed the {cfg.max_positions} this "
                         "configuration defines")
    blk = params["blocks"][layer]
    attn_p = blk["attn"]
    inv_freq = cfg.rope_inv_freq(x.device)
    h = L.rmsnorm(blk["attn_norm"], x)
    rec = L.mla_record(attn_p, h, positions, inv_freq=inv_freq)
    k, v = L.mla_expand(attn_p, rec, n_heads=cfg.n_heads, nope=cfg.qk_nope_head_dim)
    o = L.mla_causal_attention(_mla_q(cfg, attn_p, h, positions, inv_freq), k, v)
    x = x + o.reshape(*x.shape[:-1], -1) @ attn_p["wo"]
    y, aux = _ffn(params, cfg, layer, blk, L.rmsnorm(blk["mlp_norm"], x))
    return x + y, aux, rec[..., None, :]


def block_forward(params, cfg: ModelConfig, layer: int, x: torch.Tensor,
                  positions: torch.Tensor, state=None, *, return_kv: bool = False):
    """Full-sequence forward through one block: ``x [B, S, D]`` → ``(x, aux,
    kv_or_state)`` — ``aux`` the MoE load-balance loss (0 elsewhere),
    ``(k, v)`` post-RoPE for an attention block when ``return_kv`` (an MLA
    block's latent record ``[B, S, 1, kv_lora + rope]`` as both), the new
    recurrent state for a state block (Mamba2, mLSTM, sLSTM)."""
    kind = cfg.blocks[layer]
    if kind == "mla_moe":
        x, aux, rec = _mla_forward(params, cfg, layer, x, positions)
        return x, aux, ((rec, rec) if return_kv else None)
    if kind in ATTN_KINDS:
        nb, attn_p, mlp_holder = _attn_params(params, cfg, layer)
        o, k, v = L.attention(attn_p, L.rmsnorm(nb["attn_norm"], x), positions,
                              n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim, attend=L.causal_attention,
                              rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
        x = x + like(L.linear_rows(o, attn_p["wo"]), x)
        y, aux = _ffn(params, cfg, layer, mlp_holder, L.rmsnorm(mlp_holder["mlp_norm"], x))
        return _act_constrain(x + like(y, x)), aux, ((k, v) if return_kv else None)
    blk = params["blocks"][layer]
    h = L.rmsnorm(blk["norm"], x)
    if kind == "mamba2":
        y, st = S.mamba2_forward(blk["mamba"], h, state)
    elif kind == "mlstm":
        y, st = S.mlstm_forward(blk["mlstm"], h, state)
    else:
        y, st = S.slstm_forward(blk["slstm"], h, state)
    return x + like(y, x), 0.0, st


def forward(params, cfg: ModelConfig, tokens: torch.Tensor | None, *,
            embeddings: torch.Tensor | None = None, remat: bool = False):
    """Teacher-forced forward: ``tokens [B, S]`` (or ``embeddings [B, S,
    D]`` in their place) → ``(logits [B, S, V], aux)``, ``aux`` the blocks'
    MoE load-balance losses summed (0 without MoE).

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): its activations are recomputed in the backward pass,
    so the live activations are one block's, not every block's.
    """
    x = rows(L.embed_lookup(params["embed"], tokens)) if embeddings is None else embeddings
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].repeat(b, 1)
    aux_total = 0.0
    for i in range(len(cfg.blocks)):
        if remat:
            x, aux, _ = checkpoint(block_forward, params, cfg, i, x, positions,
                                   use_reentrant=False)
        else:
            x, aux, _ = block_forward(params, cfg, i, x, positions)
        aux_total = aux_total + aux
    x = L.rmsnorm(params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.linear_cols(x, head), aux_total


# --------------------------------------------------------------------------
# engine adapter
# --------------------------------------------------------------------------


class TransformerAdapter:
    """Implements :class:`repro_torch.core.adapter.ModelAdapter` for the
    port's stacks.

    ``n_layers`` counts **all** blocks; ``layer_kinds`` marks each as
    ``"kv"`` (attention, KV on disk) or ``"state"`` (Mamba2, mLSTM, sLSTM:
    recurrent state), so the engine routes state blocks through its state
    path.

    ``n_kv_heads`` and ``head_dim`` are the cache's: for latent attention
    one "head" of a record's ``kv_lora + rope`` floats, and ``kv_planes``
    1 (the record alone; a K/V pair is 2).  The engine then hands
    :meth:`decode_block` the context through :meth:`expand_context`.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_layers = len(cfg.blocks)
        self.n_heads = cfg.n_heads
        self.latent = cfg.latent
        self.n_kv_heads = 1 if self.latent else cfg.n_kv_heads
        self.head_dim = cfg.record_dim if self.latent else cfg.head_dim
        self.kv_planes = 1 if self.latent else 2
        self.max_positions = cfg.max_positions
        self.d_model = cfg.d_model
        self.d_ff = cfg.d_ff or 4 * cfg.d_model
        self.vocab_size = cfg.vocab_size
        self.layer_kinds = tuple("kv" if k in ATTN_KINDS else "state" for k in cfg.blocks)
        self._inv_freq: dict = {}

    def _rope(self, device) -> torch.Tensor:
        """An MLA block's rotary frequencies on ``device``, made once."""
        if device not in self._inv_freq:
            self._inv_freq[device] = self.cfg.rope_inv_freq(device)
        return self._inv_freq[device]

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
        x, _, (k, v) = block_forward(params, self.cfg, layer, x, positions, return_kv=True)
        return x, k, v

    def prefill_state_block(self, params, layer: int, x: torch.Tensor,
                            positions: torch.Tensor):
        """Prefill through state block ``layer`` (for Mamba2 the chunked SSD,
        kernel C on the card) → ``(x_out, state)``."""
        x, _, st = block_forward(params, self.cfg, layer, x, positions)
        return x, st

    def prefill_block_with_ctx(self, params, layer: int, x: torch.Tensor,
                               positions: torch.Tensor, k_prefix: torch.Tensor,
                               v_prefix: torch.Tensor):
        """Chunked prefill: run only the *suffix* tokens through attention
        block ``layer``, attending over restored prefix KV plus their own.

        ``x [B, S_suf, D]``, ``positions [B, S_suf]`` (absolute),
        ``k_prefix/v_prefix [B, S_pre, H_kv, d]`` (post-RoPE, as cached).
        Returns ``(x_out [B, S_suf, D], k_suf, v_suf [B, S_suf, H_kv, d])``.
        It runs op by op as :func:`block_forward` does, so it computes the
        same score rows as the cold path.  A ``moe_attn`` block routes only
        the suffix tokens, with the capacity of a call of ``S_suf`` tokens:
        that equals the cold forward only where no token is dropped, in the
        reference as here.
        """
        cfg = self.cfg
        if self.latent:
            raise ValueError("latent attention (MLA) restores no prefix: its records "
                             "are not cached across requests")
        nb, attn_p, mlp_holder = _attn_params(params, cfg, layer)
        q, k, v = _qkv(cfg, attn_p, L.rmsnorm(nb["attn_norm"], x), positions)
        k_all = torch.cat([k_prefix.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_prefix.to(v.dtype), v], dim=1)
        o = L.chunked_causal_attention(q, k_all, v_all, k_prefix.shape[1])
        x = x + o.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim) @ attn_p["wo"]
        y, _ = _ffn(params, cfg, layer, mlp_holder, L.rmsnorm(mlp_holder["mlp_norm"], x))
        return _act_constrain(x + y), k, v

    # -- decode ------------------------------------------------------------
    def gather_context(self, dev_k, dev_v, slots, tail_k, tail_v, tail_fill):
        """Device-resident context assembly (engine ``device_resident=True``):
        the step's working set gathered out of the device reuse mirror by
        slot permutation plus the device rolling tail, as the same ``(k_ctx,
        v_ctx, ctx_mask)`` triple :meth:`decode_block` takes on the
        host-gather path."""
        return L.gather_slots(dev_k, dev_v, slots, tail_k, tail_v, tail_fill, self.kv_planes)

    def expand_context(self, params, layer: int, rec_ctx: torch.Tensor):
        """An MLA layer's gathered latent records ``[B, N, 1, kv_lora + rope]``
        decompressed into its heads' ``k [B, N, H, nope + rope]`` and ``v
        [B, N, H, v]``, the context :meth:`decode_block` attends to."""
        return L.mla_expand(params["blocks"][layer]["attn"], rec_ctx[:, :, 0],
                            n_heads=self.n_heads, nope=self.cfg.qk_nope_head_dim)

    def decode_block(self, params, layer: int, x, positions, k_ctx, v_ctx, ctx_mask):
        """One-token decode: ``x [B, D]`` at ``positions [B]`` attending to the
        assembled context plus itself → ``(x_out, k_new [B, H_kv, d], v_new)``.
        An MLA block attends to its decompressed context
        (:meth:`expand_context`) and returns its new latent record ``[B, 1,
        kv_lora + rope]`` as both."""
        cfg = self.cfg
        if self.latent:
            return self._decode_mla(params, layer, x, positions, k_ctx, v_ctx, ctx_mask)
        nb, attn_p, mlp_holder = _attn_params(params, cfg, layer)
        h = L.rmsnorm(nb["attn_norm"], x)
        q, k_new, v_new = _qkv(cfg, attn_p, h[:, None], positions[:, None])
        q, k_new, v_new = q[:, 0], k_new[:, 0], v_new[:, 0]
        o = L.decode_attention(q, k_ctx, v_ctx, ctx_mask, k_new, v_new)
        x = x + o.reshape(x.shape[0], self.n_heads * self.head_dim) @ attn_p["wo"]
        h2 = L.rmsnorm(mlp_holder["mlp_norm"], x)
        if cfg.blocks[layer] == "moe_attn":
            # the step's one token a row, routed as a call of S = 1 (capacity 1)
            y = _ffn(params, cfg, layer, mlp_holder, h2[:, None])[0][:, 0]
        else:
            y = L.swiglu(mlp_holder["mlp"], h2)
        return x + y, k_new, v_new

    def _decode_mla(self, params, layer: int, x, positions, k_ctx, v_ctx, ctx_mask):
        cfg = self.cfg
        blk = params["blocks"][layer]
        attn_p = blk["attn"]
        inv_freq = self._rope(x.device)
        h = L.rmsnorm(blk["attn_norm"], x)
        rec = L.mla_record(attn_p, h, positions, inv_freq=inv_freq)
        k_new, v_new = L.mla_expand(attn_p, rec, n_heads=self.n_heads, nope=cfg.qk_nope_head_dim)
        q = _mla_q(cfg, attn_p, h, positions, inv_freq)
        o = L.decode_attention(q, k_ctx, v_ctx, ctx_mask, k_new, v_new)
        x = x + o.reshape(x.shape[0], -1) @ attn_p["wo"]
        # the step's one token a row, routed as a call of S = 1 (capacity 1)
        y = _ffn(params, cfg, layer, blk, L.rmsnorm(blk["mlp_norm"], x)[:, None])[0][:, 0]
        rec = rec[:, None]
        return x + y, rec, rec

    def decode_state_block(self, params, layer: int, x: torch.Tensor,
                           positions: torch.Tensor, state: dict):
        """One-token step of state block ``layer``: ``x [B, D]`` → ``(x_out,
        state)``."""
        blk = params["blocks"][layer]
        kind = self.cfg.blocks[layer]
        h = L.rmsnorm(blk["norm"], x)
        if kind == "mamba2":
            y, st = S.mamba2_step(blk["mamba"], h, state)
        elif kind == "mlstm":
            y, st = S.mlstm_step(blk["mlstm"], h, state)
        else:
            y, st = S.slstm_step(blk["slstm"], h, state)
        return x + y, st

    def init_state(self, params, layer: int, batch: int) -> dict:
        kind = self.cfg.blocks[layer]
        blk = params["blocks"][layer]
        if kind == "mamba2":
            return S.mamba2_init_state(blk["mamba"], batch)
        if kind == "mlstm":
            return S.mlstm_init_state(blk["mlstm"], batch)
        if kind == "slstm":
            return S.slstm_init_state(blk["slstm"], batch)
        raise ValueError(f"layer {layer} has no state")

    # -- predictor ---------------------------------------------------------
    def predict_query(self, params, layer: int, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """Layer ``layer``'s query (input norm, Q projection, qk-norm, RoPE)
        from a possibly approximate input ``x [B, D]`` → ``[B, H, d]``.  An
        MLA layer's is each head's absorbed query against the latent records
        (:func:`~repro_torch.models.layers.mla_absorbed_queries`), ``d =
        kv_lora + rope``, unscaled."""
        cfg = self.cfg
        nb, attn_p, _ = _attn_params(params, cfg, layer)
        h = L.rmsnorm(nb["attn_norm"], x)
        if self.latent:
            q = L.mla_queries(attn_p, h, positions, n_heads=self.n_heads,
                              nope=cfg.qk_nope_head_dim, inv_freq=self._rope(x.device))
            return L.mla_absorbed_queries(attn_p, q, nope=cfg.qk_nope_head_dim)
        q = (h @ attn_p["wq"]).reshape(x.shape[0], cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rmsnorm(attn_p["q_norm"], q)
        return L.apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
