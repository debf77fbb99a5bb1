"""xLSTM-1.3B — sLSTM + mLSTM blocks (attention-free).  [arXiv:2405.04517]

48 blocks at ratio ~7:1 mLSTM:sLSTM (every 8th block is sLSTM).  d_ff = 0 in
the assignment: the recurrent blocks carry their own internal projections.
KVSwap is inapplicable (no KV cache — constant-size recurrent state).
"""

from repro_torch.models.transformer import ModelConfig


def _pattern(n_layers: int) -> tuple:
    return tuple("slstm" if i % 8 == 7 else "mlstm" for i in range(n_layers))


def config() -> ModelConfig:
    n_layers = 48
    return ModelConfig(
        name="xlstm-1.3b", arch_type="ssm",
        n_layers=n_layers, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab_size=50304,
        block_pattern=_pattern(n_layers),
        tie_embeddings=True,
        source="arXiv:2405.04517",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke", arch_type="ssm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=0, vocab_size=512,
        block_pattern=("mlstm", "slstm"),
        tie_embeddings=True, source="arXiv:2405.04517",
    )
