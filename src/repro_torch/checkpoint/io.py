"""Checkpointing: flat-path ``.npz`` serialisation of a param tree.

Key paths encode the tree structure (``blocks/3/attn/wq``; ``None`` leaves
as ``<path>#none``), so checkpoints are robust to container types and
readable with ``np.load`` alone.  The format is the reference's, and the
port's params are the reference's layout as dicts of tensors, so a
checkpoint written by either package loads in the other.  Restore rebuilds
into the *structure of a template* (usually freshly initialised params),
which keeps dtype and device decisions at the caller.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is None:
            flat["/".join(path) + "#none"] = np.zeros(0)
        else:
            flat["/".join(path)] = _to_numpy(node)

    walk(tree, ())
    return flat


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` to ``path`` atomically (through ``path + ".tmp"``)."""
    flat = _flatten_with_paths(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_pytree(path: str, template):
    """Restore into the structure of ``template`` (shapes must match): a
    tensor leaf comes back as a tensor of the template's dtype on its device,
    an array leaf as an array of its dtype."""
    with np.load(path) as zf:
        flat = {k: zf[k] for k in zf.files}

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple):       # a named tuple keeps its type
            items = [rebuild(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
        if isinstance(node, list):
            return [rebuild(v, path + (str(i),)) for i, v in enumerate(node)]
        if node is None:
            return None
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if hasattr(node, "shape") and tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(node.shape)}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(arr).to(device=node.device, dtype=node.dtype)
        if hasattr(node, "dtype"):
            arr = arr.astype(node.dtype)
        return arr

    return rebuild(template, ())
