"""Partition rules: param path → partition spec over ("pod", "data", "model").

Tensor parallelism on ``model``:
  * attention: the head (fused H·d) dim of wq/wk/wv; wo reduces over it
  * FFN: d_ff of w_gate/w_up; w_down reduces over it
  * MoE: the expert axis (expert parallelism reuses the TP axis)
  * embeddings / LM head: vocab
  * Mamba2 / xLSTM: the inner expanded dim

Data parallelism on ``data`` (+ ``pod``): the batch dim of activations, or,
for ``long_500k`` (batch 1), the KV **sequence** dim (context parallelism).

A spec is the port's :class:`P`: one entry per tensor dim, each an axis
name, a tuple of axis names or ``None`` (the reference's ``PartitionSpec``
as a tuple).  :func:`to_placements` turns one into DTensor placements over
a ``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(``Shard(dim)`` on each mesh dim that splits a tensor dim, ``Replicate()``
on the others), and :func:`distribute_params` lays a param tree out over a
mesh with ``distribute_tensor``.  Specs need no process group; placements
and DTensors do.
"""

from __future__ import annotations

import math


class P(tuple):
    """A partition spec: ``P(None, "model")`` splits dim 1 over the mesh's
    ``model`` axis; ``P()`` replicates every dim.  As JAX's, a tuple of one
    axis name stands for the name and an empty tuple for ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def _path_str(path) -> str:
    """``("blocks", 3, "attn", "wq")`` → ``"blocks/3/attn/wq"``."""
    return "/".join(str(p) for p in path)


def _spec_for(path: str, leaf) -> P:
    ndim = getattr(leaf, "ndim", len(getattr(leaf, "shape", ())))
    last = path.rsplit("/", 1)[-1]

    # --- embeddings / head ------------------------------------------------
    if last == "embed":
        return P("model", None)
    if last == "lm_head":
        return P(None, "model")

    # --- MoE ---------------------------------------------------------------
    if "/moe/" in path or path.endswith("router"):
        if last == "router":
            return P(None, None)
        if last in ("w_gate", "w_up", "w_down") and ndim == 3:
            return P("model", None, None)        # expert parallel
        if "shared" in path:                     # shared expert: plain TP
            if last in ("w_gate", "w_up"):
                return P(None, "model")
            if last == "w_down":
                return P("model", None)

    # --- attention ----------------------------------------------------------
    if last in ("wq", "wk", "wv"):
        return P(None, "model")
    if last == "wo":
        return P("model", None)

    # --- dense MLP -----------------------------------------------------------
    if last in ("w_gate", "w_up"):
        return P(None, "model")
    if last == "w_down":
        return P("model", None)

    # --- Mamba2 ----------------------------------------------------------------
    if "mamba" in path:
        if last == "in_proj":
            return P(None, "model")
        if last == "out_proj":
            return P("model", None)
        if last in ("conv_w", "conv_b"):
            return P("model") if ndim == 1 else P("model", None)
        # per-head vectors (a_log, d_skip, dt_bias): small — replicate
        return P()

    # --- xLSTM -----------------------------------------------------------------
    if "mlstm" in path or "slstm" in path:
        if last in ("w_x", "w_h", "w_if"):
            return P(None, "model")
        return P()

    # norms, biases, scalars
    return P()


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop axis assignments whose dim isn't divisible by the axis size
    (whisper's 51,866 vocab doesn't split 16 ways; xLSTM's 2·H = 8 gate
    columns don't either): such dims are replicated.  ``mesh`` is a
    ``DeviceMesh`` or anything with ``mesh_dim_names`` and ``shape``."""
    sizes = _axis_sizes(mesh)
    parts = []
    for i, p in enumerate(spec):
        if p is None or i >= len(shape):
            parts.append(p)
            continue
        names = p if isinstance(p, tuple) else (p,)
        total = math.prod(sizes[n] for n in names)
        parts.append(p if shape[i] % total == 0 else None)
    return P(*parts)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple, keeping its
    structure (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_pspecs(params, mesh=None):
    """A tree of :class:`P` matching ``params``; with ``mesh`` given, each is
    sanitized against its leaf's shape."""
    def make(path, leaf):
        spec = _spec_for(_path_str(path), leaf)
        if mesh is not None and hasattr(leaf, "shape"):
            spec = sanitize_spec(spec, leaf.shape, mesh)
        return spec

    return _map_with_path(make, params)


def batch_axes(mesh) -> tuple:
    """The data-parallel axis group for this mesh (``("pod", "data")`` or ``("data",)``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def cache_pspecs(cfg, mesh, *, shard_seq: bool, kvswap: bool,
                 seq_over_model: bool = False, rolling: bool = False):
    """Specs for the serving cache of ``serving/decode.py``.

    ``shard_seq=False``: batch-sharded KV (every device owns whole
    sequences).  ``shard_seq=True``: sequence-sharded KV (long-context
    parallelism; the batch is too small to split).  ``seq_over_model=True``
    also splits the KV sequence over the ``model`` axis: KVSwap's selection
    gathers only M·G tokens, so the full cache never needs to be local.
    """
    dp = batch_axes(mesh)
    sm = "model" if seq_over_model else None
    is_whisper = type(cfg).__name__ == "WhisperConfig"
    blocks = ("attn",) * cfg.n_layers if is_whisper else cfg.blocks
    layers = []
    for kind in blocks:
        if kind in ("attn", "moe_attn", "shared_attn"):
            if shard_seq:
                seq = tuple(dp) + ("model",) if seq_over_model else dp
                ent = {"k": P(None, seq, None, None), "v": P(None, seq, None, None)}
                if kvswap:
                    ent["k_lr"] = P(None, seq, None)
                    if rolling:
                        ent["rb_k"] = P(None, None, None, None)
                        ent["rb_v"] = P(None, None, None, None)
            else:
                ent = {"k": P(dp, sm, None, None), "v": P(dp, sm, None, None)}
                if kvswap:
                    ent["k_lr"] = P(dp, sm, None)
                    if rolling:
                        ent["rb_k"] = P(dp, None, None, None)
                        ent["rb_v"] = P(dp, None, None, None)
            layers.append(ent)
        elif kind == "mamba2":
            bb = None if shard_seq else dp
            layers.append({"conv": P(bb, "model", None), "ssm": P(bb, "model", None, None)})
        elif kind == "mlstm":
            bb = None if shard_seq else dp
            layers.append({"c": P(bb, None, None, None), "n": P(bb, None, None), "m": P(bb, None)})
        elif kind == "slstm":
            bb = None if shard_seq else dp
            layers.append({"c": P(bb, None, None), "n": P(bb, None, None),
                           "h": P(bb, None, None), "m": P(bb, None)})
        else:
            raise ValueError(kind)
    out = {"layers": layers, "length": P()}
    if rolling:
        out["main_len"] = P()
    return out


def to_placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh dim's axis splits tensor dim ``d``,
    ``Replicate()`` elsewhere.  A dim split over several axes (``("data",
    "model")``) takes them major to minor, so they must come in the mesh's
    order.  An axis of size 1 splits nothing, so it replicates (the same
    layout; DTensor's view rules in torch 2.11 refuse some reshapes of a dim
    "sharded" over one device)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = _axis_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    taken = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {dim} takes axes {entry} against the mesh's "
                             f"order {names}")
        for i in idx:
            if i in taken:
                raise ValueError(f"{spec}: axis {names[i]!r} splits two dims")
            taken.add(i)
            if sizes[names[i]] > 1:
                placements[i] = Shard(dim)
    return tuple(placements)


def distribute_params(params, mesh, specs):
    """``params`` as DTensors over ``mesh``, each leaf laid out by its spec in
    ``specs`` (a tree of the same structure, e.g. :func:`param_pspecs`)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(params, dict):
        return {k: distribute_params(v, mesh, specs[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(distribute_params(v, mesh, s) for v, s in zip(params, specs))
    if params is None:
        return None
    return distribute_tensor(params, mesh, to_placements(mesh, specs))


def constrain(x, spec: P):
    """A DTensor ``x`` redistributed to ``spec`` over its own mesh; a plain
    tensor as it is (the model's sharding hooks)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(x.device_mesh, spec))
