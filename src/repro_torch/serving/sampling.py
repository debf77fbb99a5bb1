"""Samplers for the serving loop: greedy, temperature, top-k, top-p.

:class:`SamplingParams` + :func:`make_row_sampler` are the one entry point
the serving session routes through (one sampler per admitted request).
Greedy is ``torch.argmax``, which takes the first maximum as ``jnp.argmax``
does, so greedy tokens match the reference.  The stochastic sampler draws
with its own seeded CPU ``torch.Generator``: it is deterministic inside the
port, but its draws do not equal the reference's JAX threefry draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (``temperature == 0`` ⇒ greedy)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def make_row_sampler(params: SamplingParams | None = None):
    """``sampler(logits [n, V]) -> tokens [n]`` (numpy): greedy for ``None``
    or zero temperature, else a seeded categorical sampler."""
    if params is None or params.is_greedy:
        return greedy
    return make_sampler(temperature=params.temperature, top_k=params.top_k,
                        top_p=params.top_p, seed=params.seed)


def greedy(logits) -> np.ndarray:
    """Argmax of a numpy array or tensor, as a host array."""
    return torch.as_tensor(logits).argmax(dim=-1).cpu().numpy()


def greedy_device(logits: torch.Tensor) -> torch.Tensor:
    """Argmax that stays on the logits' device (no per-token host pull)."""
    return logits.argmax(dim=-1)


def make_sampler(*, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0):
    """Stateful categorical sampler: one draw per row per call from a CPU
    generator seeded with ``seed``; returns host ids."""
    gen = torch.Generator().manual_seed(seed)

    def sampler(logits) -> np.ndarray:
        lg = torch.as_tensor(logits).float().cpu() / max(temperature, 1e-6)
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        if top_p:
            sorted_lg = torch.sort(lg, dim=-1, descending=True).values
            probs = torch.softmax(sorted_lg, dim=-1)
            inside = probs.cumsum(dim=-1) - probs < top_p
            # smallest logit still inside the nucleus
            cutoff = torch.where(inside, sorted_lg, torch.full_like(sorted_lg, float("inf")))
            lg = lg.masked_fill(lg < cutoff.amin(dim=-1, keepdim=True), float("-inf"))
        probs = torch.softmax(lg, dim=-1).reshape(-1, lg.shape[-1])
        drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return drawn.reshape(lg.shape[:-1]).numpy()

    return sampler
