"""Granite-8B-Code — llama-architecture dense GQA.  [arXiv:2405.04324]"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", arch_type="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=49152, rope_theta=10000000.0,
        tie_embeddings=True,
        source="arXiv:2405.04324",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, rope_theta=10000000.0,
        tie_embeddings=True, source="arXiv:2405.04324",
    )
