"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

38 blocks; a single *shared-weight* GQA attention block is interleaved every
6 Mamba2 blocks (Zamba2's shared-transformer design).  KVSwap manages the
shared-attention KV only; the Mamba2 blocks carry O(1) recurrent state.
"""

from repro_torch.models.transformer import ModelConfig


def _pattern(n_layers: int, every: int) -> tuple:
    return tuple(
        "shared_attn" if (i % every == every - 1) else "mamba2"
        for i in range(n_layers)
    )


def config() -> ModelConfig:
    n_layers = 38
    return ModelConfig(
        name="zamba2-1.2b", arch_type="hybrid",
        n_layers=n_layers, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000, rope_theta=10000.0,
        block_pattern=_pattern(n_layers, 6),
        ssm_state=64, ssm_expand=2,
        tie_embeddings=True,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", arch_type="hybrid",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, rope_theta=10000.0,
        block_pattern=("mamba2", "shared_attn"),
        ssm_state=16, ssm_expand=2,
        tie_embeddings=True, source="arXiv:2411.15242",
    )
