"""StableLM-2-12B — dense GQA.  [hf:stabilityai/stablelm-2-1_6b family]"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", arch_type="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
        d_ff=13824, vocab_size=100352, rope_theta=10000.0,
        tie_embeddings=False,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke", arch_type="dense",
        n_layers=2, d_model=320, n_heads=8, n_kv_heads=2, head_dim=40,
        d_ff=640, vocab_size=512, rope_theta=10000.0,
        tie_embeddings=False, source="hf:stabilityai/stablelm-2-1_6b",
    )
