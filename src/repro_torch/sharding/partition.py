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

:func:`local_region` runs a function on each rank's shards (DTensor's
``local_map``, the counterpart of JAX's ``shard_map``) where DTensor's
sharding rules cannot take its ops; on plain tensors it runs the function
itself, so the single-device path keeps its bits.
"""

from __future__ import annotations

import functools
import math

import torch


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


def mesh_of(tree):
    """The device mesh of the first DTensor in ``tree`` (nested dicts, lists
    and tuples), or ``None``.  Without a process group there is no DTensor:
    the plain path skips the walk."""
    if not torch.distributed.is_available() or not torch.distributed.is_initialized():
        return None
    from torch.distributed.tensor import DTensor

    def find(node):
        if isinstance(node, DTensor):
            return node.device_mesh
        if isinstance(node, dict):
            node = node.values()
        elif not isinstance(node, (list, tuple)):
            return None
        return next((m for m in map(find, node) if m is not None), None)

    return find(tree)


def axis_size(mesh, names) -> int:
    """The number of ranks along ``names`` (an axis name or a tuple of
    them; ``None`` and axes the mesh lacks count 1)."""
    if mesh is None or names is None:
        return 1
    sizes = _axis_sizes(mesh)
    return math.prod(sizes.get(n, 1) for n in ((names,) if isinstance(names, str) else names))


def axis_index(mesh, names) -> int:
    """This rank's coordinate along ``names``, major to minor (0 off a mesh)."""
    if mesh is None or names is None:
        return 0
    idx = 0
    for n in ((names,) if isinstance(names, str) else names):
        if n in mesh.mesh_dim_names:
            idx = idx * mesh.size(mesh.mesh_dim_names.index(n)) + mesh.get_local_rank(n)
    return idx


def split_axes(mesh, names, n: int):
    """``names`` where they split a dim of ``n`` evenly and more than one way,
    else ``None`` (the dim stays whole on every rank)."""
    k = axis_size(mesh, names)
    return names if k > 1 and n % k == 0 else None


def local_region(fn, args: tuple, layout):
    """``fn(*args)`` on each rank's shards when ``args`` hold a DTensor.

    ``layout(mesh)`` gives ``(in_specs, out_specs, kwargs)``.  ``in_specs``
    has one entry per entry of ``args``: a :class:`P` or a tuple of DTensor
    placements (for every tensor in the entry), or a dict of them for a
    dict entry; non-tensors take none.  ``out_specs`` is a list, one entry
    per tensor in ``fn``'s flattened result (``None`` for a non-tensor), or
    one spec for a lone tensor; a tuple of placements may hold partial sums.
    ``kwargs`` go to ``fn`` on this rank (its offsets).  Each input is
    redistributed to its spec (a plain tensor counts as replicated), ``fn``
    runs on the local tensors, and its outputs come back as DTensors of the
    out specs (``local_map``).  Without a DTensor, ``fn(*args)`` runs as it
    is, with its own defaults.

    Gradients: an input whole over a mesh axis along which ``fn``'s outputs
    are split (sharded or partial) gets its gradient as a partial sum over
    that axis (each rank's share); over an axis where every output is whole
    — every rank computes the same thing — its gradient is whole too.  A
    4th entry of ``layout``'s result overrides which axes count as split.
    """
    mesh = mesh_of(args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_unflatten as pt_unflatten

    in_specs, out_specs, kwargs, *split = layout(mesh)
    rep = (Replicate(),) * mesh.ndim
    flat_args, in_pl = [], []
    for arg, spec in zip(args, in_specs, strict=True):
        leaves, tree = tree_flatten(arg)
        specs = (tree_flatten({k: spec[k] for k in arg}, is_leaf=_is_spec)[0]
                 if isinstance(spec, dict) else [spec] * len(leaves))
        out = []
        for leaf, sp in zip(leaves, specs, strict=True):
            if isinstance(leaf, torch.Tensor):
                if not isinstance(leaf, DTensor):
                    leaf = DTensor.from_local(leaf, mesh, rep, run_check=False)
                in_pl.append(_placements(mesh, sp))
            else:
                in_pl.append(None)
            out.append(leaf)
        flat_args.append(pt_unflatten(out, tree))
    # local_map reads a tuple as one placement list per output, and a list
    # as the placements of a lone output
    outs = [_placements(mesh, s) for s in (out_specs if isinstance(out_specs, list)
                                           else [out_specs])]
    out_pl = tuple(outs) if isinstance(out_specs, list) else list(outs[0])
    if split:
        split_dims = {i for i, n in enumerate(mesh.mesh_dim_names)
                      if n in (split[0] or ())}
    else:
        split_dims = {i for pl in outs if pl is not None for i, p in enumerate(pl)
                      if not isinstance(p, Replicate)}
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and i in split_dims else p
        for i, p in enumerate(pl)) for pl in in_pl)
    return local_map(functools.partial(fn, **kwargs), out_placements=out_pl,
                     in_placements=tuple(in_pl), in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*flat_args)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) or x is None


def _placements(mesh, spec):
    """A :class:`P` as placements over ``mesh``; placements as they are."""
    from torch.distributed.tensor import Placement

    if spec is None:
        return None
    if spec and all(isinstance(p, Placement) for p in spec):
        return tuple(spec)
    return to_placements(mesh, spec)


def partial_placements(mesh, spec: P, axes) -> tuple:
    """:func:`to_placements` of ``spec`` with each mesh axis in ``axes`` (a
    name, a tuple of names or ``None``) a pending sum over its ranks
    instead: a rank's output that is only its share of the whole."""
    from torch.distributed.tensor import Partial

    names = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
    return tuple(Partial() if n in names and mesh.size(i) > 1 else p
                 for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, to_placements(mesh, spec))))


def rows(x):
    """A DTensor activation laid out by rows: its first dim over the batch
    axes where they divide it, whole on every other axis (the model's
    residual stream); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(mesh, P(split_axes(mesh, batch_axes(mesh),
                                                                 x.shape[0]))))


def like(y, x):
    """DTensor ``y`` (a partial sum, say) brought to ``x``'s placements, so
    that ``x + y`` keeps ``x``'s layout; a plain ``y`` as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not isinstance(x, DTensor):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def shard_dim(x, axis: str):
    """The tensor dim that mesh axis ``axis`` splits in DTensor ``x``
    (``None`` for a plain tensor, an axis ``x``'s mesh lacks, or a whole or
    partial placement there)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor) or axis not in x.device_mesh.mesh_dim_names:
        return None
    pl = x.placements[x.device_mesh.mesh_dim_names.index(axis)]
    return pl.dim if isinstance(pl, Shard) and x.device_mesh.size(
        x.device_mesh.mesh_dim_names.index(axis)) > 1 else None


def gather_over(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Inside a region: ``t`` of every rank along mesh axis ``axis``,
    concatenated along ``dim`` in rank order (an all-gather whose backward
    sums each rank's share of the gradient back to it)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    dim = dim % t.dim()
    out = torch.ops._c10d_functional.wait_tensor(
        torch.ops._c10d_functional_autograd.all_gather_into_tensor(
            t.contiguous(), n, mesh.get_group(axis).group_name))
    out = out.reshape(n, *t.shape)
    return out.movedim(0, dim).reshape(*t.shape[:dim], n * t.shape[dim], *t.shape[dim + 1:])


def sum_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Inside a region: the sum of ``t`` over the ranks along ``axis``
    (each rank's partial share in, the whole on every rank out)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    return gather_over(t[None], mesh, axis, 0).sum(0)
