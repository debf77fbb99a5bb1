"""Llama-4-Maverick-400B-A17B — MoE (128 experts, top-1) + early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family]

Llama-4 interleaves dense and MoE FFN layers and adds a shared expert to
each MoE layer; top-1 routing with 128 routed experts.
"""

from repro_torch.models.transformer import ModelConfig


def _pattern(n_layers: int) -> tuple:
    # MoE every other layer (interleave_moe_layer_step = 2)
    return tuple("moe_attn" if i % 2 == 1 else "attn" for i in range(n_layers))


def config() -> ModelConfig:
    n_layers = 48
    return ModelConfig(
        name="llama4-maverick-400b-a17b", arch_type="moe",
        n_layers=n_layers, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048, rope_theta=500000.0,
        block_pattern=_pattern(n_layers),
        n_experts=128, moe_top_k=1, moe_d_ff=8192, moe_shared_d_ff=8192,
        tie_embeddings=False,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", arch_type="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, rope_theta=500000.0,
        block_pattern=("attn", "moe_attn"),
        n_experts=4, moe_top_k=1, moe_d_ff=128, moe_shared_d_ff=128,
        tie_embeddings=False, source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
