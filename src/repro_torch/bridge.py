"""Load reference weights into the port, layout for layout.

The reference keeps params as a pytree of arrays (``init_params`` in
``repro/models/transformer.py``) and the low-rank adapter as
``LowRankAdapter.a [H_k·d, r]``.  The port uses the same layout in plain
dicts of tensors, so loading is a leaf-by-leaf copy.  The caller converts
JAX arrays to numpy first (``jax.tree_util.tree_map(np.asarray, params)``);
this module only ever sees numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lowrank import LowRankAdapter
from repro_torch.device import resolve


def params_from_numpy(tree, device=None):
    """Copy a nested dict/list/tuple of numpy arrays to tensors on ``device``
    (``None`` = the CUDA card), keeping the structure and every key."""
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.tensor(np.asarray(node), device=dev)

    return conv(tree)


def adapter_from_numpy(a: np.ndarray, n_kv_heads: int, head_dim: int,
                       device=None) -> LowRankAdapter:
    """The reference adapter matrix ``a [H_k·d, r]`` as the port's adapter."""
    return LowRankAdapter(a=torch.tensor(np.asarray(a), device=resolve(device)),
                          n_kv_heads=n_kv_heads, head_dim=head_dim)
