"""Chameleon-34B — early-fusion VLM over VQ image tokens.  [arXiv:2405.09818]

Early fusion means the backbone is a plain causal transformer over an
interleaved text+image *token* stream (the VQ-VAE image tokenizer is the
stubbed frontend — ``input_specs`` supplies token ids drawn from the unified
65,536 vocab).  Chameleon uses qk-norm for training stability; we keep it.
"""

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", arch_type="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536, rope_theta=10000.0,
        qk_norm=True, tie_embeddings=False,
        source="arXiv:2405.09818",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", arch_type="vlm",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, rope_theta=10000.0,
        qk_norm=True, tie_embeddings=False, source="arXiv:2405.09818",
    )
