"""Decode-time prediction through kernel A (KVSwap Eq. 1).

The low-rank query projection (an einsum) feeds
:func:`repro_torch.kernels.ops.lowrank_group_scores` — score, head sum and
group reduce-max in one kernel on the card, its plain version on the CPU —
and top-M selection stays in PyTorch (a stable sort, lower index first on
ties), as it stayed outside the Pallas body in the reference.  Returns
device ``(ids [B, M], mask [B, M])``, which the engine pulls to the host
once per layer.
"""

from __future__ import annotations

import torch

from repro_torch.core.predictor import lowrank_queries_per_head, select_groups
from repro_torch.kernels import ops


def fused_predict(q: torch.Tensor, per_head_a: torch.Tensor, k_lr: torch.Tensor,
                  valid_len: torch.Tensor, *, group_size: int,
                  n_select: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``q [B, H, d]`` (normed, RoPE'd), ``per_head_a [H_k, d, r]``,
    ``k_lr [B, N, r]``, ``valid_len [B]`` int32 → ``(ids, mask) [B, M]``."""
    q_lr = lowrank_queries_per_head(q, per_head_a).contiguous()
    gs = ops.lowrank_group_scores(q_lr, k_lr, valid_len, group_size=group_size)
    return select_groups(gs, n_select)
