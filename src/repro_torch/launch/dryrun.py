"""Multi-pod dry run: every (architecture × input shape × mesh) step laid out
over the production meshes, and the roofline terms counted from it — the
port of :mod:`repro.launch.dryrun`.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out exp.json]

The reference forces 512 placeholder CPU devices, jits each step over a
16×16 (or 2×16×16) mesh and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and the collectives of the optimised HLO.  PyTorch has
no SPMD compiler to ask, so this port runs the step itself, once, as rank 0
of a world of 256 (or 512) ranks:

* the world is a default process group of the ``fake`` backend
  (:func:`repro_torch.launch.mesh.fake_world`), which moves no data;
* params, optimizer state, cache and inputs are fake local shards (no
  storage) wrapped as DTensors at their placements with
  ``DTensor.from_local`` — not ``distribute_tensor``, whose layout
  collectives would count as the step's;
* the step runs under ``FakeTensorMode`` with the model's DTensor forward
  (:func:`repro_torch.sharding.partition.local_region` where DTensor's own
  rules do not reach), and :class:`LocalCounter` counts what rank 0's local
  ops do.

So this is the one entry point of the port that uses no device: it
computes nothing, as the reference's dry run computes nothing on its
placeholder CPUs.  The kernel wrappers take their plain versions on the
fake CPU shards, and the counts are those of the plain PyTorch path (the
reference's dry run lowers its plain ``jnp`` path too).

:class:`DryrunResult` has the reference's fields and JSON schema, with
these meanings here:

* ``flops`` — FLOPs of rank 0's local ops, by ``torch.utils.flop_counter``'s
  formulas (the DTensor-level op at its global shape is not counted);
* ``bytes_accessed`` — the sum of each local op's input and output bytes
  (view ops move none).  The ops run unfused, one kernel each, so the sum
  is larger than XLA's figure for its fused program;
* ``collectives`` — the bytes of each collective's local input, by the
  reference's names (all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-permute), ``total``, and ``_counts``, the number of each
  (the reference's parse keeps them, its ``run_one`` drops them);
  ``collective_bytes`` is the total.  On the CPU mesh DTensor turns a
  shard-to-shard move into an all-gather and a chunk, so it counts as an
  all-gather;
* ``memory`` — ``argument_bytes``, the local bytes of every input;
  ``output_bytes``, the local bytes of what the step returns (the cache and
  the optimizer state are updated in place and returned, so they count
  there too); ``temp_bytes``, the peak of the live local bytes the step
  allocated beyond its arguments; ``code_bytes`` 0;
* ``lower_s`` — the seconds the traced step took; ``compile_s`` 0: eager
  PyTorch has no compile step.

The step updates the cache (decode, prefill) or the params and AdamW state
(train) in place, the port's only mode; ``donate=False`` (``--no-donate``)
clones them inside the step first, so the result shows the copy.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.serving import decode as D
from repro_torch.serving.decode import KVSwapServeConfig
from repro_torch.sharding import partition as SP
from repro_torch.sharding.partition import P
from repro_torch.training.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.training.train import softmax_xent, value_and_grad
from repro_torch.utils.treeops import tree_leaves, tree_unflatten

# Architectures whose weights are too large to replicate across the data
# axis — FSDP (shard over 'data') for all modes, not just training.
FSDP_ALWAYS = {"llama4-maverick-400b-a17b"}

# KVSwap serving defaults for decode shapes (paper: MG = 400, G = 4).
SERVE_KVSWAP = KVSwapServeConfig(group_size=4, n_select=100, rank=64)

# A combination whose traced step would take longer than this many seconds
# of one CPU core is reported ``not run`` instead of traced.
BUDGET_S = 900.0

# Seconds a token of an xLSTM block adds to a traced step, by step kind and
# block: the sLSTM's token loop (one fused cell a token) and the mLSTM's
# chunk loop (one carry a chunk of 64).  The marginal cost of a step of 4
# blocks of one kind at 256 → 512 (train) and 1,024 → 2,048 tokens
# (prefill), at xLSTM-1.3B's width on a 16x16 fake world, on one shared CPU
# core.  The scans are the only parts whose trace grows with a Python loop.
XLSTM_TOKEN_S = {"train": {"mlstm": 0.00011, "slstm": 0.0053},
                 "prefill": {"mlstm": 0.000013, "slstm": 0.0015}}


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

def _fsdp_spec(spec: P) -> P:
    """Add 'data' sharding to the largest replicated dim of a weight spec."""
    parts = list(spec)
    if "data" in parts:
        return spec
    for i, p in enumerate(parts):
        if p is None:
            parts[i] = "data"
            return P(*parts)
    return spec


def _map_specs(fn, specs, leaves=None):
    """``fn(spec)`` (or ``fn(spec, leaf)``) over a tree of :class:`P`."""
    if isinstance(specs, P):
        return fn(specs) if leaves is None else fn(specs, leaves)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, None if leaves is None else leaves[k])
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        items = [_map_specs(fn, v, None if leaves is None else leaves[i])
                 for i, v in enumerate(specs)]
        return type(specs)(*items) if hasattr(specs, "_fields") else type(specs)(items)
    return specs


def param_shardings(params_shape, mesh, *, fsdp: bool):
    """The tree of :class:`P` that lays ``params_shape`` out over ``mesh``
    (the reference returns ``NamedSharding``s; a spec and the mesh are the
    same thing here): :func:`~repro_torch.sharding.param_pspecs`, and with
    ``fsdp`` each weight also split over ``data`` on its first whole dim."""
    specs = SP.param_pspecs(params_shape, mesh)
    if fsdp:
        specs = _map_specs(_fsdp_spec, specs)
        specs = _map_specs(lambda sp, leaf: SP.sanitize_spec(sp, leaf.shape, mesh),
                           specs, params_shape)
    return specs


def uses_kvswap(cfg) -> bool:
    """KVSwap selection applies iff the arch has softmax-attention KV."""
    if registry.is_whisper(cfg):
        return True
    return any(k in ("attn", "moe_attn", "shared_attn") for k in cfg.blocks)


# ---------------------------------------------------------------------------
# step builders: (fn, abstract args, specs)
# ---------------------------------------------------------------------------
#
# The abstract args are tensors with the shapes and dtypes of the step's
# arguments (fake ones: the builders run under the caller's
# ``FakeTensorMode``), and host ints where the port keeps one; the specs are
# a tree of :class:`P` of the same structure.

def _params(cfg, rank: int | None = None, dtype=torch.bfloat16):
    params = registry.init_params(cfg, generator=torch.Generator(), device="cpu", dtype=dtype)
    if rank is not None:
        params = D.attach_kvswap_adapters(params, cfg, rank, generator=torch.Generator(),
                                          dtype=dtype)
    return params


def build_train(cfg, shape: InputShape, mesh, *, fsdp: bool):
    is_whisper = registry.is_whisper(cfg)
    dp = SP.batch_axes(mesh)
    params_shape = _params(cfg)
    opt_shape = adamw_init(params_shape)
    opt_cfg = AdamWConfig()

    if is_whisper:
        from repro_torch.models import whisper as W

        def loss_fn(params, batch):
            enc = W.encode(params, cfg, batch["frames"])
            logits, _ = W.decoder_forward(params, cfg, batch["tokens"], enc)
            loss = softmax_xent(logits, batch["targets"])
            return loss, {}
    else:
        from repro_torch.models import transformer as T

        def loss_fn(params, batch):
            logits, aux = T.forward(params, cfg, batch["tokens"])
            loss = softmax_xent(logits, batch["targets"])
            return (loss + 0.01 * aux if cfg.n_experts else loss), {}

    def train_step(params, opt, batch):
        loss, _, grads = value_and_grad(loss_fn, params, batch)
        params, opt = adamw_update(params, tree_unflatten(params, grads), opt, opt_cfg)
        return params, opt, loss

    b, s = shape.global_batch, shape.seq_len
    batch_shape = {"tokens": torch.empty((b, s), dtype=torch.int32),
                   "targets": torch.empty((b, s), dtype=torch.int32)}
    batch_spec = {"tokens": P(dp, None), "targets": P(dp, None)}
    if is_whisper:
        batch_shape["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model),
                                            dtype=torch.bfloat16)
        batch_spec["frames"] = P(dp, None, None)

    p_spec = param_shardings(params_shape, mesh, fsdp=True)    # train always FSDP
    # AdamW step counter is a scalar — replicate
    o_spec = AdamWState(step=P(), mu=p_spec, nu=p_spec)
    return train_step, (params_shape, opt_shape, batch_shape), (p_spec, o_spec, batch_spec)


def build_prefill(cfg, shape: InputShape, mesh, *, fsdp: bool, kvswap: bool):
    is_whisper = registry.is_whisper(cfg)
    dp = SP.batch_axes(mesh)
    b, s = shape.global_batch, shape.seq_len
    scfg = SERVE_KVSWAP if kvswap else None
    params_shape = _params(cfg, scfg.rank if scfg else None)
    cache_shape = D.init_cache(cfg, b, s, dtype=torch.bfloat16, kvswap=scfg, device="cpu")
    tokens = torch.empty((b, s), dtype=torch.int32)

    if is_whisper:
        def step(params, tokens, cache, enc_out):
            return D.prefill(params, cfg, tokens, cache, kvswap=scfg, enc_out=enc_out)
        args = (params_shape, tokens, cache_shape,
                torch.empty((b, cfg.enc_frames, cfg.d_model), dtype=torch.bfloat16))
        extra_spec = (P(dp, None, None),)
    else:
        def step(params, tokens, cache):
            return D.prefill(params, cfg, tokens, cache, kvswap=scfg)
        args = (params_shape, tokens, cache_shape)
        extra_spec = ()

    cache_spec = SP.cache_pspecs(cfg, mesh, shard_seq=False, kvswap=kvswap)
    specs = (param_shardings(params_shape, mesh, fsdp=fsdp), P(dp, None), cache_spec) + extra_spec
    return step, args, specs


def build_decode(cfg, shape: InputShape, mesh, *, fsdp: bool, kvswap: bool,
                 seq_over_model: bool = False, rolling: bool = False,
                 serve: KVSwapServeConfig = SERVE_KVSWAP, dtype=torch.bfloat16,
                 length: int | None = None):
    """The decode step at a full cache: ``length = seq_len − 1`` tokens
    held (unless ``length`` is given), the new one written into the next
    slot (with ``rolling``, the main cache flushed to ``length + 1 − G`` and
    the rolling buffer one short of full), so attention covers the whole
    context, as the reference's masked step does.  ``serve`` and ``dtype``
    (of the params, cache and frames) are the dry run's unless given."""
    is_whisper = registry.is_whisper(cfg)
    dp = SP.batch_axes(mesh)
    b, s = shape.global_batch, shape.seq_len
    shard_seq = b == 1                     # long_500k: context parallelism
    scfg = None
    if kvswap:
        scfg = dataclasses.replace(serve, rolling=rolling)
    params_shape = _params(cfg, scfg.rank if scfg else None, dtype)
    cache_shape = D.init_cache(cfg, b, s, dtype=dtype, kvswap=scfg, device="cpu")
    cache_shape["length"] = s - 1 if length is None else length
    if scfg is not None and scfg.rolling:
        cache_shape["main_len"] = cache_shape["length"] + 1 - scfg.rb_len
    tokens = torch.empty((b, 1), dtype=torch.int32)

    if is_whisper:
        def step(params, tokens, cache, enc_out):
            return D.serve_step(params, cfg, tokens, cache, kvswap=scfg, enc_out=enc_out)
        args = (params_shape, tokens, cache_shape,
                torch.empty((b, cfg.enc_frames, cfg.d_model), dtype=dtype))
        extra_spec = (P(None if shard_seq else dp, None, None),)
    else:
        def step(params, tokens, cache):
            return D.serve_step(params, cfg, tokens, cache, kvswap=scfg)
        args = (params_shape, tokens, cache_shape)
        extra_spec = ()

    cache_spec = SP.cache_pspecs(cfg, mesh, shard_seq=shard_seq, kvswap=kvswap,
                                 seq_over_model=seq_over_model, rolling=rolling)
    tok_spec = P() if shard_seq else P(dp, None)
    specs = (param_shardings(params_shape, mesh, fsdp=fsdp), tok_spec, cache_spec) + extra_spec
    return step, args, specs


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def _local_shape(shape, placements, mesh) -> tuple:
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            if out[pl.dim] % mesh.size(i):
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split "
                                 f"{mesh.size(i)} ways over {mesh.mesh_dim_names[i]!r}")
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def local_shards(args, specs, mesh):
    """``args`` (abstract tensors and host ints) as DTensors over ``mesh``
    whose local tensors are fresh fake shards (no storage, no collective):
    each leaf at the placements of its spec.  Host ints stay ints."""
    from torch.distributed.tensor import DTensor

    def make(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = SP.to_placements(mesh, spec)
        local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape, device="meta").stride())

    return _map_specs(make, specs, args)


def local_bytes(tree) -> int:
    """Bytes of the local tensors of every DTensor (or tensor) in ``tree``,
    each storage once."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


# ---------------------------------------------------------------------------
# counting rank 0's local ops
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# collective op name fragments → the reference's names; ``wait_tensor`` moves
# nothing of its own
_COLL_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
               ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
               ("alltoall", "all-to-all"), ("permute", "collective-permute"))
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional", "c10d",
                    "_dtensor")


def _collective_kind(func) -> str | None:
    """The reference's name of a collective op, ``None`` for another op."""
    if func.namespace not in _COMM_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    if name == "wait_tensor":
        return ""
    for frag, kind in _COLL_KINDS:
        if frag in name:
            return kind
    raise ValueError(f"collective {func} has no counterpart among {_COLLECTIVES}")


class LocalCounter:
    """What rank 0's local ops do under ``with counter:`` — FLOPs, bytes,
    collectives and the peak of live bytes — while the DTensor ops that
    dispatch them pass through uncounted.

    A ``TorchDispatchMode`` that declines every op on a DTensor (so
    DTensor's dispatch runs, and its local ops come back to the mode) and
    counts the rest; DTensor's shape propagation, which runs an op once at
    its global shape on fake placeholders, is not counted either.  Storages
    alive at ``__enter__`` (the arguments) are not counted as allocated.
    """

    def __init__(self, args=()):
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(_COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(_COLLECTIVES, 0)
        self.peak = 0
        self._args = {t.untyped_storage()._cdata for t in _local_tensors(args)}
        self._live: dict[int, tuple[int, object]] = {}
        self._cur = 0
        self._quiet = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        counter = self
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, op_schema):
            counter._quiet += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._quiet -= 1

        self._stack.enter_context(_patched(ShardingPropagator,
                                           "_propagate_tensor_meta_non_cached", propagate))
        self._stack.enter_context(_CountingMode(self))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def _record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            if kind and ins:
                self.coll_bytes[kind] += _nbytes(ins[0])
                self.coll_counts[kind] += 1
        else:
            if func._overloadpacket in flop_registry:
                self.flops += int(flop_registry[func._overloadpacket](*args, **kwargs,
                                                                       out_val=out))
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._args and key not in self._live:
                n = st.nbytes()
                self._live[key] = (n, weakref.ref(st, functools.partial(self._freed, key)))
                self._cur += n
        self.peak = max(self.peak, self._cur)

    def _freed(self, key: int, _ref) -> None:
        """A storage the step allocated died (its weakref's callback)."""
        self._cur -= self._live.pop(key)[0]

    def collectives(self) -> dict:
        out = dict(self.coll_bytes)
        out["_counts"] = dict(self.coll_counts)
        out["total"] = sum(self.coll_bytes.values())
        return out


def _tensors(tree, out: list | None = None) -> list:
    """The tensors in an op's arguments or result (nested lists, tuples and
    dicts), in order.  A plain recursion: a closure that calls itself would
    be a reference cycle, and keep every tensor it saw alive until the
    collector runs."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


# metadata queries that dispatch like ops but compute nothing (as
# FlopCounterMode skips them)
_METADATA_OPS = ("sym_is_contiguous", "is_contiguous", "is_strides_like_format",
                 "is_non_overlapping_and_dense", "size", "sym_size", "stride", "sym_stride",
                 "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim")


class _CountingMode(TorchDispatchMode):
    """The dispatch mode of :class:`LocalCounter`."""

    def __init__(self, counter: LocalCounter):
        super().__init__()
        self.counter = counter
        self.skip = {torch.ops.prim.layout.default, torch.ops.prim.device.default}
        for name in _METADATA_OPS:
            packet = getattr(torch.ops.aten, name, None)
            self.skip.update(getattr(packet, o) for o in (packet.overloads() if packet else ()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if DTensor in types or any(isinstance(t, DTensor) for t in _tensors((args, kwargs))):
            return NotImplemented
        if self.counter._quiet or func in self.skip:
            return func(*args, **kwargs)
        # as FlopCounterMode: an op without a formula counts as its
        # decomposition where it has one
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.counter._record(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# one dry-run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    kvswap: bool
    ok: bool = False
    error: str = ""
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)


def _clone_state(tree):
    """``tree`` with every tensor cloned (host ints kept): the copy a step
    that cannot update its state in place makes."""
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_clone_state(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def measure(step, args: tuple, specs: tuple, mesh) -> dict:
    """Run ``step`` once on fake local shards of ``args`` (laid out by
    ``specs`` over ``mesh``) under :class:`LocalCounter` → ``flops``,
    ``bytes``, ``collectives``, ``memory`` and ``seconds``.  Call it inside a
    ``FakeTensorMode``, over a world that holds ``mesh``."""
    from torch.distributed.tensor.experimental import implicit_replication

    dargs = local_shards(args, specs, mesh)
    arg_bytes = local_bytes(dargs)          # before the step replaces any state
    counter = LocalCounter(dargs)
    t0 = time.perf_counter()
    with implicit_replication(), counter:
        out = step(*dargs)
    seconds = time.perf_counter() - t0
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": counter.collectives(), "seconds": seconds,
            "memory": {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
                       "temp_bytes": counter.peak, "code_bytes": 0}}


def _undonated(step, state_args):
    """``step`` with the arguments at ``state_args`` cloned inside it."""
    def run(*args):
        args = list(args)
        for i in state_args:
            args[i] = _clone_state(args[i])
        return step(*args)
    return run


def build_step(cfg, shape: InputShape, mesh, *, fsdp: bool, kvswap: bool,
               seq_over_model: bool = False, rolling: bool = False):
    """:func:`build_train`, :func:`build_prefill` or :func:`build_decode` by
    the shape's kind (prefill without KVSwap, as the reference's
    ``run_one``) → ``(step, args, specs, state_args)``, ``state_args`` the
    arguments the step updates in place."""
    if shape.kind == "train":
        return (*build_train(cfg, shape, mesh, fsdp=fsdp), (0, 1))   # params, opt state
    if shape.kind == "prefill":
        return (*build_prefill(cfg, shape, mesh, fsdp=fsdp, kvswap=False), (2,))  # cache
    return (*build_decode(cfg, shape, mesh, fsdp=fsdp, kvswap=kvswap,
                          seq_over_model=seq_over_model, rolling=rolling and bool(kvswap)),
            (2,))                                                     # cache


def _run_on(mesh, cfg, shape: InputShape, *, fsdp: bool, kvswap: bool, donate: bool,
            moe_pspecs: bool, seq_over_model: bool, rolling: bool, seq_parallel: bool) -> dict:
    """:func:`run_one`'s step built and measured over ``mesh``, in a fresh
    ``FakeTensorMode``, with the reference's per-arch gating of the MoE and
    sequence-parallel hooks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dp = SP.batch_axes(mesh)
    small_moe = not registry.is_whisper(cfg) and cfg.n_experts and cfg.d_model < 4096
    if (moe_pspecs and not registry.is_whisper(cfg) and cfg.n_experts
            and shape.kind != "decode" and not small_moe):
        L.set_moe_pspecs({"buf": P(dp, None, None, None), "y": P(dp, None, None)})
    else:
        L.set_moe_pspecs(None)
    sp_applies = (shape.kind == "train"
                  or (not registry.is_whisper(cfg) and bool(cfg.n_experts)) and not small_moe)
    T.set_activation_pspec(
        P(dp, "model", None)
        if seq_parallel and not registry.is_whisper(cfg) and not small_moe and sp_applies
        else None)
    with FakeTensorMode():
        step, args, specs, state_args = build_step(cfg, shape, mesh, fsdp=fsdp, kvswap=kvswap,
                                                   seq_over_model=seq_over_model,
                                                   rolling=rolling)
        if not donate:
            step = _undonated(step, state_args)
        return measure(step, args, specs, mesh)


def scan_seconds(cfg, shape: InputShape) -> float:
    """The estimated seconds the xLSTM scans of ``cfg``'s blocks take to
    trace at ``shape`` (:data:`XLSTM_TOKEN_S`; 0 for a decode step and for
    other blocks)."""
    per = XLSTM_TOKEN_S.get(shape.kind)
    if per is None or registry.is_whisper(cfg):
        return 0.0
    return shape.seq_len * sum(per.get(k, 0.0) for k in cfg.blocks)


def run_one(arch_id: str, shape_name: str, *, multi_pod: bool = False,
            kvswap: bool | None = None, verbose: bool = True,
            donate: bool = True, moe_pspecs: bool = True,
            seq_over_model: bool = False, rolling: bool = False,
            seq_parallel: bool = False) -> DryrunResult:
    """One dry run over a fresh fake world of 256 (or 512) ranks.
    ``donate`` (the port's only mode) updates the cache (decode/prefill) or
    the params and opt state (train) in place; ``donate=False`` clones them
    inside the step.  ``moe_pspecs`` pins the MoE dispatch's output to the
    reference's layout where the reference does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_fake_production_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = registry.get(arch_id)
    shape = SHAPES[shape_name]
    fsdp = arch_id in FSDP_ALWAYS
    if kvswap is None:
        kvswap = shape.kind == "decode" and uses_kvswap(cfg)
    res = DryrunResult(arch=arch_id, shape=shape_name,
                       mesh="2x16x16" if multi_pod else "16x16", kvswap=kvswap)
    est = scan_seconds(cfg, shape)
    if est > BUDGET_S:
        res.error = (f"not run: tracing the xLSTM scans over {shape.seq_len} tokens (a token "
                     f"loop in each of its {cfg.blocks.count('slstm')} sLSTM blocks, a chunk "
                     f"loop in each of its {cfg.blocks.count('mlstm')} mLSTM blocks) would take "
                     f"about {est:.0f} s, over the {BUDGET_S:.0f} s budget")
        if verbose:
            print(f"[FAIL] {arch_id} × {shape_name} × {res.mesh}: {res.error}", flush=True)
        return res
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_fake_production_mesh(multi_pod=multi_pod)
            got = _run_on(mesh, cfg, shape, fsdp=fsdp, kvswap=kvswap, donate=donate,
                          moe_pspecs=moe_pspecs, seq_over_model=seq_over_model,
                          rolling=rolling, seq_parallel=seq_parallel)
        res.lower_s = got["seconds"]
        res.memory = got["memory"]
        res.flops = float(got["flops"])
        res.bytes_accessed = float(got["bytes"])
        res.collective_bytes = int(got["collectives"]["total"])
        res.collectives = got["collectives"]
        res.ok = True
        if verbose:
            print(f"[ok] {arch_id} × {shape_name} × {res.mesh} kvswap={kvswap} "
                  f"lower={res.lower_s:.1f}s compile={res.compile_s:.1f}s "
                  f"flops={res.flops:.3e} coll={res.collective_bytes:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res.ok = False
        res.error = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch_id} × {shape_name} × {res.mesh}: {res.error[:300]}", flush=True)
    finally:
        L.set_moe_pspecs(None)
        T.set_activation_pspec(None)
    return res


def decode_one_rank(cfg, batch: int, max_len: int, length: int, *,
                    serve: KVSwapServeConfig | None, dtype=torch.float32) -> dict:
    """:func:`measure` of one decode step of ``cfg`` (``batch`` rows, a
    cache of ``max_len`` holding ``length`` tokens, ``serve``'s selection or
    ``None`` for full attention, params and cache in ``dtype``) as the one
    rank of a fake world of one, over a 1×1 mesh: the counts of the step
    the same arguments run on one device, to hold against a real run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_mesh_auto

    shape = InputShape("one-rank", max_len, batch, "decode")
    with fake_world(1):
        mesh = make_mesh_auto((1, 1), ("data", "model"), device="cpu")
        with FakeTensorMode():
            step, args, specs = build_decode(cfg, shape, mesh, fsdp=False,
                                             kvswap=serve is not None,
                                             serve=serve or SERVE_KVSWAP, dtype=dtype,
                                             length=length)
            return measure(step, args, specs, mesh)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=registry.list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="sweep all arch × shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--full-attn", action="store_true",
                    help="decode shapes without KVSwap selection (baseline)")
    ap.add_argument("--no-donate", action="store_true",
                    help="clone the state inside the step instead of updating it in place")
    ap.add_argument("--no-moe-pspecs", action="store_true",
                    help="disable the MoE dispatch's sharding hooks: the expert buffer's "
                         "layout between dispatch, experts and combine ('buf'), and the "
                         "routed output's ('y')")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper decode optimizations: seq-over-model "
                         "cache sharding + device rolling buffer (§Perf)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    combos = []
    archs = registry.list_archs() if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    results = []
    for a, s, mp in combos:
        kv = False if args.full_attn else None
        results.append(run_one(a, s, multi_pod=mp, kvswap=kv,
                               donate=not args.no_donate,
                               moe_pspecs=not args.no_moe_pspecs,
                               seq_over_model=args.opt, rolling=args.opt,
                               seq_parallel=args.opt))

    n_ok = sum(r.ok for r in results)
    print(f"\n{n_ok}/{len(results)} combinations traced on the fake world")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(r) for r in results], f, indent=1)
        print(f"wrote {args.out}")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
