"""Assigned input shapes + ``input_specs`` (``meta``-tensor stand-ins) — the
port of :mod:`repro.configs.shapes`.

Shapes (from the reproduction brief):

=============  ==========  ============  ==================
id             seq_len     global_batch  step kind
=============  ==========  ============  ==================
train_4k       4,096       256           train_step
prefill_32k    32,768      32            prefill
decode_32k     32,768      128           serve_step (1 tok)
long_500k      524,288     1             serve_step (1 tok)
=============  ==========  ============  ==================

Decode shapes run ``serve_step`` — ONE new token against a KV cache of
``seq_len``.  ``long_500k`` goes through the KVSwap selected-group attention
(sub-quadratic) for attention archs, and natively for SSM/hybrid.

Where the reference returns ``jax.ShapeDtypeStruct``s, these functions
return ``torch.empty(shape, dtype=dtype, device="meta")``: a shape and a
dtype, no storage.  The cache's ``length`` is a 0-d int32 stand-in, as the
reference's (the port's serving cache keeps it as a host int).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _is_whisper(cfg) -> bool:
    return type(cfg).__name__ == "WhisperConfig"


def input_specs(cfg, shape: InputShape, *, act_dtype=torch.bfloat16) -> dict:
    """Stand-ins for every model input of (arch × shape).

    For [audio] the stub frontend supplies frame embeddings; for [vlm] the
    early-fusion stream is discrete tokens (VQ codes share the vocab).
    """
    b, s = shape.global_batch, shape.seq_len
    is_whisper = _is_whisper(cfg)
    if shape.kind == "train":
        spec = {
            "tokens": _sds((b, s), torch.int32),
            "targets": _sds((b, s), torch.int32),
        }
        if is_whisper:
            spec["frames"] = _sds((b, cfg.enc_frames, cfg.d_model), act_dtype)
        return spec
    if shape.kind == "prefill":
        spec = {"tokens": _sds((b, s), torch.int32)}
        if is_whisper:
            spec["frames"] = _sds((b, cfg.enc_frames, cfg.d_model), act_dtype)
        return spec
    # decode: one new token + per-layer KV / recurrent state
    spec = {
        "tokens": _sds((b, 1), torch.int32),
        "cache": decode_cache_specs(cfg, b, s, act_dtype=act_dtype),
    }
    if is_whisper:
        spec["enc_out"] = _sds((b, cfg.enc_frames, cfg.d_model), act_dtype)
    return spec


def decode_cache_specs(cfg, batch: int, seq_len: int, *, act_dtype=torch.bfloat16) -> dict:
    """Per-layer cache stand-ins matching ``serving.decode.init_cache``."""
    blocks = ("attn",) * cfg.n_layers if _is_whisper(cfg) else cfg.blocks
    layers = []
    for kind in blocks:
        if kind in ("attn", "moe_attn", "shared_attn"):
            layers.append({
                "k": _sds((batch, seq_len, cfg.n_kv_heads, cfg.head_dim), act_dtype),
                "v": _sds((batch, seq_len, cfg.n_kv_heads, cfg.head_dim), act_dtype),
            })
        elif kind == "mamba2":
            di = cfg.ssm_expand * cfg.d_model
            nh = di // 64
            layers.append({
                "conv": _sds((batch, di + 2 * cfg.ssm_state, 3), act_dtype),
                "ssm": _sds((batch, nh, 64, cfg.ssm_state), act_dtype),
            })
        elif kind == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            layers.append({
                "c": _sds((batch, cfg.n_heads, hd, hd), act_dtype),
                "n": _sds((batch, cfg.n_heads, hd), act_dtype),
                "m": _sds((batch, cfg.n_heads), act_dtype),
            })
        elif kind == "slstm":
            hd = cfg.d_model // cfg.n_heads
            layers.append({
                "c": _sds((batch, cfg.n_heads, hd), act_dtype),
                "n": _sds((batch, cfg.n_heads, hd), act_dtype),
                "h": _sds((batch, cfg.n_heads, hd), act_dtype),
                "m": _sds((batch, cfg.n_heads), act_dtype),
            })
        else:
            raise ValueError(kind)
    return {"layers": layers, "length": _sds((), torch.int32)}
