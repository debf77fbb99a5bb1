"""OLMoE-1B-7B — MoE, 64 experts top-8.  [arXiv:2409.02060]"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    n_layers = 16
    return ModelConfig(
        name="olmoe-1b-7b", arch_type="moe",
        n_layers=n_layers, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50304, rope_theta=10000.0,
        block_pattern=("moe_attn",) * n_layers,
        n_experts=64, moe_top_k=8, moe_d_ff=1024,
        tie_embeddings=False,
        source="arXiv:2409.02060",
    )


def smoke_config() -> ModelConfig:
    n_layers = 2
    return ModelConfig(
        name="olmoe-1b-7b-smoke", arch_type="moe",
        n_layers=n_layers, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=64, vocab_size=512, rope_theta=10000.0,
        block_pattern=("moe_attn",) * n_layers,
        n_experts=4, moe_top_k=2, moe_d_ff=64,
        tie_embeddings=False, source="arXiv:2409.02060",
    )
