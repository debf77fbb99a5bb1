"""Qwen3-8B — the paper's second evaluation model (App. B Tab. 1).
Bonus config beyond the assigned pool.  [arXiv:2505.09388]
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", arch_type="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12288, vocab_size=151936, rope_theta=1000000.0,
        qk_norm=True, tie_embeddings=False,
        source="arXiv:2505.09388",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, rope_theta=1000000.0,
        qk_norm=True, tie_embeddings=False, source="arXiv:2505.09388",
    )
