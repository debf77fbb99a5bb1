"""Small tree utilities (param counting, byte accounting, flattening) over
nested dicts, lists and tuples of tensors, arrays and scalars, in the
place of ``jax.tree_util``; ``None`` is an empty subtree, as there."""

from __future__ import annotations

import numpy as np


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_leaves(tree) -> list:
    """The leaves in order (dicts in insertion order)."""
    return list(_leaves(tree))


def tree_unflatten(template, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``template``'s structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        return None if node is None else next(it)

    return build(template)


def tree_count(tree) -> int:
    """Total number of scalar elements across all leaves (a scalar counts 1)."""
    return int(sum(np.prod(tuple(l.shape)) if hasattr(l, "shape") else 1 for l in _leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes across all array and tensor leaves."""
    total = 0
    for l in _leaves(tree):
        if hasattr(l, "nbytes"):
            total += int(l.nbytes)
        elif hasattr(l, "shape") and hasattr(l, "dtype"):
            total += int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
    return total
