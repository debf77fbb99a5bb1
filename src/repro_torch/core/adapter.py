"""Model adapter protocol: the contract between the KVSwap engine and any
attention-bearing model in the zoo.

The engine is model-agnostic; a model plugs in by implementing this protocol
(see ``repro.models.transformer.TransformerAdapter``).  All arrays are torch tensors;
the engine moves them to/from host numpy at the disk boundary.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class ModelAdapter(Protocol):
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    vocab_size: int

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [B, S] -> x [B, S, D]``."""
        ...

    def prefill_block(self, params, layer: int, x: torch.Tensor, positions: torch.Tensor):
        """Full-attention prefill through block ``layer``.

        ``x [B, S, D] -> (x_out [B, S, D], k [B, S, H_kv, d], v [B, S, H_kv, d])``
        K is post-RoPE (what gets cached).
        """
        ...

    def prefill_block_with_ctx(
        self,
        params,
        layer: int,
        x: torch.Tensor,            # [B, S_suf, D] suffix activations
        positions: torch.Tensor,    # [B, S_suf] absolute positions
        k_prefix: torch.Tensor,     # [B, S_pre, H_kv, d] restored prefix K (post-RoPE)
        v_prefix: torch.Tensor,     # [B, S_pre, H_kv, d]
    ):
        """Chunked prefill for the prefix cache: run only the suffix tokens,
        attending over restored prefix KV plus their own.  Returns
        ``(x_out [B, S_suf, D], k_suf, v_suf [B, S_suf, H_kv, d])`` and must
        match :meth:`prefill_block`'s suffix rows bit-for-bit when the prefix
        KV is bit-identical (see ``KVSwapEngine.prefill_cached``)."""
        ...

    def decode_block(
        self,
        params,
        layer: int,
        x: torch.Tensor,            # [B, D] current token activations
        positions: torch.Tensor,    # [B] absolute positions of the new token
        k_ctx: torch.Tensor,        # [B, N_sel, H_kv, d] assembled context K
        v_ctx: torch.Tensor,        # [B, N_sel, H_kv, d]
        ctx_mask: torch.Tensor,     # [B, N_sel] bool validity
    ):
        """One-token decode through block ``layer`` attending to the assembled
        context plus itself.  Returns ``(x_out [B, D], k_new [B, H_kv, d],
        v_new [B, H_kv, d])``."""
        ...

    def gather_context(
        self,
        dev_k: torch.Tensor,        # [B, C, G, H_kv, d] device reuse mirror (K)
        dev_v: torch.Tensor,        # [B, C, G, H_kv, d] device reuse mirror (V)
        slots: torch.Tensor,        # [B, M] slot permutation (-1 invalid, -2 staged)
        tail_k: torch.Tensor,       # [B, G, H_kv, d] device rolling tail (K)
        tail_v: torch.Tensor,       # [B, G, H_kv, d]
        tail_fill: torch.Tensor,    # [B] valid tail tokens per row
    ):
        """OPTIONAL — device-resident context assembly.  Gather the selected
        groups from the persistent device buffers by slot index and append
        the rolling tail (masked per row by ``tail_fill`` — rows advance
        independently under continuous batching); returns the ``(k_ctx,
        v_ctx, ctx_mask)`` triple :meth:`decode_block` takes.  Adapters
        without it force the engine's host-gather path
        (``EngineConfig.device_resident`` is ignored)."""
        ...

    def predict_query(self, params, layer: int, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Layer ``layer``'s Q projection applied to (possibly approximate)
        input ``x [B, D]`` — includes the block's input norm, qk-norm and RoPE
        so the predictor sees the same geometry as the real attention.
        Returns ``[B, H, d]``."""
        ...

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head: ``[B, D] or [B, S, D] -> [..., vocab]``."""
        ...
