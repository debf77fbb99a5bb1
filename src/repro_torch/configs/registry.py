"""Architecture registry of the port: ``--arch <id>`` → config + model builders.

The arch names and their configs are the reference's, every one of them.
"""

from __future__ import annotations

import importlib

import torch

# the reference's arch names, in its order; the paper's second evaluation
# model, beyond the assigned pool, comes last
ARCHS = ("llama3-8b", "olmoe-1b-7b", "stablelm-12b", "zamba2-1.2b", "qwen3-32b",
         "granite-8b", "chameleon-34b", "llama4-maverick-400b-a17b",
         "whisper-large-v3", "xlstm-1.3b")
ALL_ARCHS = ARCHS + ("qwen3-8b",)
_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
}


def list_archs() -> tuple:
    return ARCHS


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCHS}")
    return importlib.import_module(_MODULES[arch_id])


def get(arch_id: str):
    """Full-scale config for an architecture."""
    return _module(arch_id).config()


def smoke(arch_id: str):
    """Reduced smoke-test config of the same family."""
    return _module(arch_id).smoke_config()


def is_whisper(cfg) -> bool:
    return type(cfg).__name__ == "WhisperConfig"


def build_adapter(cfg):
    """Engine adapter for any registered config."""
    if is_whisper(cfg):
        from repro_torch.models.whisper import WhisperAdapter
        return WhisperAdapter(cfg)
    from repro_torch.models.transformer import TransformerAdapter
    return TransformerAdapter(cfg)


def init_params(cfg, *, generator: torch.Generator, device=None, dtype=torch.float32):
    """Random weights in the reference layout, drawn from ``generator``."""
    if is_whisper(cfg):
        from repro_torch.models import whisper
        return whisper.init_params(cfg, generator=generator, device=device, dtype=dtype)
    from repro_torch.models import transformer
    return transformer.init_params(cfg, generator=generator, device=device, dtype=dtype)
