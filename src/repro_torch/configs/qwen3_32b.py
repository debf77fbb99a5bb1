"""Qwen3-32B — dense GQA with qk-norm.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", arch_type="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab_size=151936, rope_theta=1000000.0,
        qk_norm=True, tie_embeddings=False,
        source="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, rope_theta=1000000.0,
        qk_norm=True, tie_embeddings=False, source="hf:Qwen/Qwen3-8B",
    )
