"""Whisper-large-v3 — encoder-decoder audio model; conv frontend stubbed.
[arXiv:2212.04356]
"""

from repro_torch.models.whisper import WhisperConfig


def config() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-large-v3",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab_size=51866, enc_frames=1500,
        source="arXiv:2212.04356",
    )


def smoke_config() -> WhisperConfig:
    return WhisperConfig(
        name="whisper-large-v3-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, n_enc_layers=2, enc_frames=64,
        source="arXiv:2212.04356",
    )
