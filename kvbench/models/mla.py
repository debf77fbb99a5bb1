"""A multi-head latent attention (MLA) decoder with routed experts in every
layer (Mistral-Small-4, DeepSeek-V3's layer) from its published config
file: the benchmark's weights, and how the program under test
(``repro_torch``) is built on them.

The file's ``n_routed_experts`` counts the experts this card holds, the
first of the layer's ``n_routed_experts_published``: the router keeps its
published width, and each card of an expert-parallel deployment computes
its own experts' part.  The leaves are the benchmark's; :func:`port_params`
only arranges the same tensors in the program's parameter layout, and
:func:`port_config` maps the published keys onto the program's
``ModelConfig``.
"""

from __future__ import annotations

import dataclasses
import math

from kvbench.models.decoder import engine_config  # noqa: F401  (the same tuple)


def _program_has_mla() -> None:
    """Stop at once, before the weights are drawn, if the program under
    test has no latent attention."""
    from repro_torch.models.transformer import ModelConfig

    if "kv_lora_rank" not in {f.name for f in dataclasses.fields(ModelConfig)}:
        raise SystemExit("the program under test has no latent attention (MLA)")


def leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    _program_has_mla()
    d, v, h = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    f, e, el = cfg["moe_intermediate_size"], cfg["n_routed_experts_published"], cfg["n_routed_experts"]
    fs = cfg["n_shared_experts"] * f
    out = [("embed", (v, d), 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), None), (p + "mlp_norm", (d,), None),
                (p + "wq_a", (d, ql), 1 / math.sqrt(d)), (p + "q_norm", (ql,), None),
                (p + "wq_b", (ql, h * (nope + rope)), 1 / math.sqrt(ql)),
                (p + "wkv_a", (d, kl + rope), 1 / math.sqrt(d)), (p + "kv_norm", (kl,), None),
                (p + "wkv_b", (kl, h * (nope + vd)), 1 / math.sqrt(kl)),
                (p + "wo", (h * vd, d), 1 / math.sqrt(h * vd)),
                (p + "router", (d, e), 0.02),
                (p + "w_gate", (el, d, f), 1 / math.sqrt(d)),
                (p + "w_up", (el, d, f), 1 / math.sqrt(d)),
                (p + "w_down", (el, f, d), 1 / math.sqrt(f)),
                (p + "shared_gate", (d, fs), 1 / math.sqrt(d)),
                (p + "shared_up", (d, fs), 1 / math.sqrt(d)),
                (p + "shared_down", (fs, d), 1 / math.sqrt(fs))]
    return out + [("final_norm", (d,), None), ("lm_head", (d, v), 1 / math.sqrt(d))]


def port_config(cfg: dict, engine: dict):
    """The program's ``ModelConfig`` for the published keys; a key whose
    value the program does not implement is refused."""
    from repro_torch.models.transformer import ModelConfig, Yarn

    rp = cfg["rope_parameters"]
    unsupported = {"attention_bias": cfg.get("attention_bias"), "mlp_bias": cfg.get("mlp_bias"),
                   "first_k_dense_replace": cfg.get("first_k_dense_replace"),
                   "n_group > 1": cfg.get("n_group", 1) > 1,
                   "routed_scaling_factor != 1": cfg.get("routed_scaling_factor", 1) != 1,
                   "norm_topk_prob false": not cfg.get("norm_topk_prob"),
                   "rope not yarn": rp.get("rope_type") != "yarn",
                   "rope not interleaved": not cfg.get("rope_interleave"),
                   "mscale != mscale_all_dim": rp.get("mscale") != rp.get("mscale_all_dim"),
                   "tied embeddings": cfg.get("tie_word_embeddings")}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the program's MLA decoder does not implement: {bad}")
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    n = cfg["num_hidden_layers"]
    return ModelConfig(
        name=cfg.get("name", "kvbench"), arch_type="moe", n_layers=n, d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_attention_heads"],
        head_dim=nope + rope, d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        block_pattern=("mla_moe",) * n, rope_theta=float(rp["rope_theta"]),
        n_experts=cfg["n_routed_experts_published"], moe_experts_held=cfg["n_routed_experts"],
        moe_top_k=cfg["num_experts_per_tok"], moe_d_ff=cfg["moe_intermediate_size"],
        moe_shared_d_ff=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
        moe_capacity_factor=0.0, moe_router="sigmoid",
        q_lora_rank=cfg["q_lora_rank"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=nope, qk_rope_head_dim=rope, v_head_dim=cfg["v_head_dim"],
        yarn=Yarn(factor=float(rp["factor"]),
                  original_max_position=rp["original_max_position_embeddings"],
                  beta_fast=float(rp["beta_fast"]), beta_slow=float(rp["beta_slow"]),
                  mscale_all_dim=float(rp["mscale_all_dim"])),
        tie_embeddings=False)


def port_params(cfg: dict, w: dict) -> dict:
    """The benchmark's tensors ``w`` in the program's parameter layout; no
    tensor is copied."""
    blocks = []
    for lw in w["layers"]:
        attn = {k: lw[k] for k in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")}
        attn |= {"q_norm": {"scale": lw["q_norm"]}, "kv_norm": {"scale": lw["kv_norm"]}}
        moe = {k: lw[k] for k in ("router", "w_gate", "w_up", "w_down")}
        moe["shared"] = {k: lw["shared_" + k[2:]] for k in ("w_gate", "w_up", "w_down")}
        blocks.append({"attn_norm": {"scale": lw["attn_norm"]}, "attn": attn,
                       "mlp_norm": {"scale": lw["mlp_norm"]}, "moe": moe})
    return {"embed": w["embed"], "blocks": blocks, "final_norm": {"scale": w["final_norm"]},
            "lm_head": w["lm_head"]}


def kv_bytes_per_token(cfg: dict) -> int:
    """Bytes the fp32 store writes for one token of one row: one latent
    record (``kv_lora + rope`` floats) a layer."""
    return cfg["num_hidden_layers"] * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * 4


def flops_per_token(cfg: dict) -> int:
    """Model FLOPs of one token without its attention: two a weight it
    multiplies through.  A layer: ``W_qa``, ``W_qb``, ``W_kva``, ``W_kvb``
    (its own record decompressed once), ``W_o``, the router (all
    ``n_routed_experts_published`` outputs), the shared expert, and the
    routed experts' expected share on this card, ``k · held / published``
    experts of three ``d × moe_intermediate_size`` matrices; then the LM
    head.  The decode path decompresses each gathered record again every
    step; that repeat is the implementation's, not the model's, and is not
    counted (nor are the attention's products, which ``mfu_pct`` adds from
    kernel B's launches)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    ql, kl, f = cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    attn = d * ql + ql * h * (nope + rope) + d * (kl + rope) + kl * h * (nope + vd) + h * vd * d
    routed = (3 * d * f * cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
              // cfg["n_routed_experts_published"])
    ffn = d * cfg["n_routed_experts_published"] + 3 * d * f * cfg["n_shared_experts"] + routed
    return 2 * (cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"])
