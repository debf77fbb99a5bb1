"""Whisper-style encoder-decoder (audio) backbone — the PyTorch port of
:mod:`repro.models.whisper`.

The modality front end (mel spectrogram and conv feature extractor) is a
stub, as in the reference: ``encode`` takes frame embeddings ``[B, S_enc,
D]`` at the post-conv rate.  The transformer backbone (encoder
self-attention, decoder self- and cross-attention) is real.  Both encoder
and decoder use sinusoidal positions, as the reference does (real Whisper
learns the decoder's).

KVSwap manages the decoder's *self*-attention KV; the cross-attention KV is
fixed once the encoder has run and stays on the device (about 1.5 K
frames).  :class:`WhisperAdapter` has no ``gather_context``, so the engine
takes its host-gather route for it, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_layers: int              # decoder layers (the encoder uses the same count)
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    n_enc_layers: int = 0      # 0 → same as n_layers
    enc_frames: int = 1500     # post-conv frame count (30 s of audio)
    arch_type: str = "audio"
    source: str = ""

    @property
    def enc_layers(self) -> int:
        return self.n_enc_layers or self.n_layers


def sinusoid_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embeddings of ``positions [...]`` → ``[..., d_model]`` fp32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device, dtype=torch.float32)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_attn_block(cfg: WhisperConfig, *, cross: bool, generator, device, dtype) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    attn_kw = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim, **kw)
    blk = {
        "ln1": L.init_layernorm(cfg.d_model, device=device, dtype=dtype),
        "attn": L.init_attention(**attn_kw),
        "ln_mlp": L.init_layernorm(cfg.d_model, device=device, dtype=dtype),
        "mlp": L.init_gelu_mlp(d_model=cfg.d_model, d_ff=cfg.d_ff, **kw),
    }
    if cross:
        blk["ln_cross"] = L.init_layernorm(cfg.d_model, device=device, dtype=dtype)
        blk["cross"] = L.init_attention(**attn_kw)
    return blk


def init_params(cfg: WhisperConfig, *, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random weights in the reference layout, drawn from ``generator``
    (which must live on ``device``): the embedding ``N(0, 0.02²)``, dense
    matrices ``N(0, 1/fan_in)``, layer norms 1 and 0, biases 0."""
    dev = resolve(device)
    kw = dict(generator=generator, device=dev, dtype=dtype)
    return {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), **kw).mul_(0.02),
        "enc_blocks": [_init_attn_block(cfg, cross=False, **kw) for _ in range(cfg.enc_layers)],
        "enc_norm": L.init_layernorm(cfg.d_model, device=dev, dtype=dtype),
        "dec_blocks": [_init_attn_block(cfg, cross=True, **kw) for _ in range(cfg.n_layers)],
        "final_norm": L.init_layernorm(cfg.d_model, device=dev, dtype=dtype),
    }


def _proj_qkv(p, x: torch.Tensor, cfg: WhisperConfig):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def encode(params, cfg: WhisperConfig, frames: torch.Tensor) -> torch.Tensor:
    """Encoder over stubbed frame embeddings ``[B, S_enc, D]``."""
    b, s, _ = frames.shape
    x = frames + sinusoid_positions(torch.arange(s, device=frames.device), cfg.d_model)[None]
    for blk in params["enc_blocks"]:
        q, k, v = _proj_qkv(blk["attn"], L.layernorm(blk["ln1"], x), cfg)
        o = L.bidirectional_attention(q, k, v)
        x = x + o.reshape(b, s, -1) @ blk["attn"]["wo"]
        x = x + L.gelu_mlp(blk["mlp"], L.layernorm(blk["ln_mlp"], x))
    return L.layernorm(params["enc_norm"], x)


def cross_kv(params, cfg: WhisperConfig, enc_out: torch.Tensor) -> list:
    """Each decoder layer's cross-attention ``(K, V) [B, S_enc, H_kv, d]``
    from the encoder output."""
    b, s, _ = enc_out.shape
    return [((enc_out @ blk["cross"]["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
             (enc_out @ blk["cross"]["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim))
            for blk in params["dec_blocks"]]


def cross_and_mlp(blk, cfg: WhisperConfig, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """A decoder block's cross-attention over ``(ck, cv)`` and its MLP, each
    with its residual: ``x [B, S, D]``, or ``[B, D]`` for one decode token."""
    hc = L.layernorm(blk["ln_cross"], x)
    lead = hc.shape[:-1]
    qc = (hc @ blk["cross"]["wq"]).reshape(*lead, cfg.n_heads, cfg.head_dim)
    if hc.dim() == 2:                    # decode: add a seq axis
        oc = L.bidirectional_attention(qc[:, None], ck, cv)[:, 0]
    else:
        oc = L.bidirectional_attention(qc, ck, cv)
    x = x + oc.reshape(*lead, -1) @ blk["cross"]["wo"]
    return x + L.gelu_mlp(blk["mlp"], L.layernorm(blk["ln_mlp"], x))


def decoder_forward(params, cfg: WhisperConfig, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> tuple[torch.Tensor, None]:
    """Teacher-forced decoder: ``tokens [B, S]`` → ``(logits [B, S, V],
    None)``, as the reference returns it (no auxiliary loss)."""
    b, s = tokens.shape
    x = params["embed"][tokens] + sinusoid_positions(
        torch.arange(s, device=tokens.device), cfg.d_model)[None]
    for blk, (ck, cv) in zip(params["dec_blocks"], cross_kv(params, cfg, enc_out)):
        q, k, v = _proj_qkv(blk["attn"], L.layernorm(blk["ln1"], x), cfg)
        o = L.causal_attention(q, k, v)
        x = x + o.reshape(b, s, -1) @ blk["attn"]["wo"]
        x = cross_and_mlp(blk, cfg, x, ck, cv)
    return L.layernorm(params["final_norm"], x) @ params["embed"].T, None


class WhisperAdapter:
    """:class:`repro_torch.core.adapter.ModelAdapter` over the *decoder*; the
    encoder output is set per request with :meth:`set_encoder_output`.

    Every decoder layer is a "kv" layer for the engine (self-attention KV);
    cross-attention runs on the device inside each block.  There is no
    ``gather_context``: the engine assembles the context on the host.
    """

    def __init__(self, cfg: WhisperConfig):
        self.cfg = cfg
        self.n_layers = cfg.n_layers
        self.n_heads = cfg.n_heads
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = cfg.head_dim
        self.d_model = cfg.d_model
        self.d_ff = cfg.d_ff
        self.vocab_size = cfg.vocab_size
        self.layer_kinds = ("kv",) * cfg.n_layers
        self._cross: list | None = None

    def set_encoder_output(self, params, enc_out: torch.Tensor) -> None:
        self._cross = cross_kv(params, self.cfg, enc_out)

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # positions are added at layer 0, where they are known
        return params["embed"][tokens]

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return L.layernorm(params["final_norm"], x) @ params["embed"].T

    def _cross_and_mlp(self, blk, x: torch.Tensor, layer: int) -> torch.Tensor:
        if self._cross is None:
            raise RuntimeError("call set_encoder_output() before decoding")
        ck, cv = self._cross[layer]
        return cross_and_mlp(blk, self.cfg, x, ck, cv)

    def prefill_block(self, params, layer: int, x: torch.Tensor, positions: torch.Tensor):
        """``x [B, S, D]`` → ``(x_out, k [B, S, H_kv, d], v)``."""
        cfg = self.cfg
        blk = params["dec_blocks"][layer]
        if layer == 0:
            x = x + sinusoid_positions(positions, cfg.d_model)
        b, s, _ = x.shape
        q, k, v = _proj_qkv(blk["attn"], L.layernorm(blk["ln1"], x), cfg)
        o = L.causal_attention(q, k, v)
        x = x + o.reshape(b, s, -1) @ blk["attn"]["wo"]
        return self._cross_and_mlp(blk, x, layer), k, v

    def decode_block(self, params, layer: int, x, positions, k_ctx, v_ctx, ctx_mask):
        """One-token decode: ``x [B, D]`` at ``positions [B]`` attending to the
        assembled context plus itself → ``(x_out, k_new [B, H_kv, d], v_new)``."""
        cfg = self.cfg
        blk = params["dec_blocks"][layer]
        if layer == 0:
            x = x + sinusoid_positions(positions, cfg.d_model)
        h = L.layernorm(blk["ln1"], x)
        b = x.shape[0]
        q = (h @ blk["attn"]["wq"]).reshape(b, cfg.n_heads, cfg.head_dim)
        k_new = (h @ blk["attn"]["wk"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
        v_new = (h @ blk["attn"]["wv"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
        o = L.decode_attention(q, k_ctx, v_ctx, ctx_mask, k_new, v_new)
        x = x + o.reshape(b, -1) @ blk["attn"]["wo"]
        return self._cross_and_mlp(blk, x, layer), k_new, v_new

    def predict_query(self, params, layer: int, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """Layer ``layer``'s query from a possibly approximate input ``x [B,
        D]`` → ``[B, H, d]``."""
        cfg = self.cfg
        blk = params["dec_blocks"][layer]
        if layer == 0:
            x = x + sinusoid_positions(positions, cfg.d_model)
        h = L.layernorm(blk["ln1"], x)
        return (h @ blk["attn"]["wq"]).reshape(x.shape[0], cfg.n_heads, cfg.head_dim)
