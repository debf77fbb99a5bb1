"""A llama-style decoder (dense SwiGLU or top-k routed experts) from its
published config file: the benchmark's weights, and how the program under
test (``repro_torch``) is built on them.

The leaves are the benchmark's; :func:`port_params` only arranges the same
tensors in the program's parameter layout, and :func:`port_config` maps the
published keys onto the program's ``ModelConfig``.
"""

from __future__ import annotations

import dataclasses
import math

from kvbench import roofline


def leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    h, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    e = cfg.get("num_experts", 0)
    out = [("embed", (v, d), 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), None), (p + "mlp_norm", (d,), None),
                (p + "wq", (d, h * hd), 1 / math.sqrt(d)),
                (p + "wk", (d, hk * hd), 1 / math.sqrt(d)),
                (p + "wv", (d, hk * hd), 1 / math.sqrt(d)),
                (p + "wo", (h * hd, d), 1 / math.sqrt(h * hd))]
        if e:
            out += [(p + "router", (d, e), 0.02),
                    (p + "w_gate", (e, d, f), 1 / math.sqrt(d)),
                    (p + "w_up", (e, d, f), 1 / math.sqrt(d)),
                    (p + "w_down", (e, f, d), 1 / math.sqrt(f))]
        else:
            out += [(p + "w_gate", (d, f), 1 / math.sqrt(d)),
                    (p + "w_up", (d, f), 1 / math.sqrt(d)),
                    (p + "w_down", (f, d), 1 / math.sqrt(f))]
    out.append(("final_norm", (d,), None))
    if not cfg.get("tie_word_embeddings"):
        out.append(("lm_head", (d, v), 1 / math.sqrt(d)))
    return out


def port_config(cfg: dict, engine: dict):
    """The program's ``ModelConfig`` for the published keys."""
    from repro_torch.models.transformer import ModelConfig

    if cfg.get("attention_bias") or cfg.get("mlp_bias"):
        raise ValueError("the program's decoder layers carry no projection biases")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    e = cfg.get("num_experts", 0)
    kw = dict(n_experts=e, moe_top_k=cfg["num_experts_per_tok"], moe_d_ff=cfg["intermediate_size"],
              block_pattern=("moe_attn",) * cfg["num_hidden_layers"]) if e else {}
    if "moe_capacity_factor" in engine:
        kw["moe_capacity_factor"] = engine["moe_capacity_factor"]
    return ModelConfig(
        name=cfg.get("name", "kvbench"), arch_type="moe" if e else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim") or d // h,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), qk_norm=False,
        tie_embeddings=bool(cfg.get("tie_word_embeddings")), **kw)


def port_params(cfg: dict, w: dict) -> dict:
    """The benchmark's tensors ``w`` (nested, :func:`kvbench.weights.nested`)
    in the program's parameter layout; no tensor is copied."""
    blocks = []
    for lw in w["layers"]:
        ffn = {k: lw[k] for k in ("w_gate", "w_up", "w_down")}
        blk = {"attn_norm": {"scale": lw["attn_norm"]}, "mlp_norm": {"scale": lw["mlp_norm"]},
               "attn": {k: lw[k] for k in ("wq", "wk", "wv", "wo")}}
        if "router" in lw:
            blk["moe"] = {"router": lw["router"], **ffn}
        else:
            blk["mlp"] = ffn
        blocks.append(blk)
    params = {"embed": w["embed"], "blocks": blocks, "final_norm": {"scale": w["final_norm"]}}
    if "lm_head" in w:
        params["lm_head"] = w["lm_head"]
    return params


def engine_config(engine: dict):
    from repro_torch.core.engine import EngineConfig

    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    return EngineConfig(**{k: v for k, v in engine.items() if k in fields})


def kv_bytes_per_token(cfg: dict) -> int:
    """Bytes the fp32 KV store writes for one token of one row."""
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    return cfg["num_hidden_layers"] * 2 * cfg["num_key_value_heads"] * hd * 4


def flops_per_token(cfg: dict) -> int:
    """Model FLOPs of one token without its attention: two a weight it
    multiplies through (:func:`kvbench.roofline.matmul_params_per_token`)."""
    return 2 * roofline.matmul_params_per_token(cfg)
