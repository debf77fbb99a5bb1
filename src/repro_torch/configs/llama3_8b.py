"""LLaMA-3.1-8B — dense GQA, 128K vocab.  [arXiv:2407.21783]

The paper's own primary evaluation model (Tabs. 2, 4, 5).
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", arch_type="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256, rope_theta=500000.0,
        tie_embeddings=False,
        source="arXiv:2407.21783",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, rope_theta=500000.0,
        tie_embeddings=False, source="arXiv:2407.21783",
    )
