"""The port's shape tables (``configs/shapes.py``) and the dry run's
per-rank argument bytes against the JAX package's.

``SHAPES``, ``input_specs`` and ``decode_cache_specs`` must equal the
reference's in every shape and dtype, for every arch of the registry × every
shape.  The argument bytes of each (arch × shape kind × mesh) — params,
AdamW state, cache and inputs, laid out by the port's ``build_*`` and
counted on its fake local shards — must equal the bytes the reference's
specs give (``repro.sharding.partition`` over a duck-typed mesh,
``jax.eval_shape`` for the leaves), leaf for leaf, except for the leaves
named in ``_port_dtype``: the reference's dense matrices are float32 and
the port's bfloat16, and the cache's ``length`` is a host int in the port.
``repro.launch.dryrun`` is never imported here: its first lines would give
every later test of this process 512 host devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.serving import decode as JD
from repro.sharding import partition as JSP
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch.configs import registry
from repro_torch.configs import shapes

_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}


@dataclasses.dataclass
class FakeMesh:
    """Axis names and sizes, in both packages' spelling."""
    axis_names: tuple
    shape: tuple

    @property
    def mesh_dim_names(self):
        return self.axis_names

    @property
    def devices(self):
        return np.empty(self.shape, dtype=np.int8)


MESHES = {"16x16": FakeMesh(("data", "model"), (16, 16)),
          "2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16))}


def _flat(tree, path=()):
    """``{"a/0/k": leaf}`` over dicts, lists and tuples (a ``P`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, JP):
        fields = getattr(tree, "_fields", None)
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + ((fields[i] if fields else i),)).items()}
    return {"/".join(map(str, path)): tree}


def test_shapes_table_matches_reference():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in shapes.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshapes.SHAPES[name])


def test_input_specs_match_reference_for_every_arch_and_shape():
    n = 0
    for arch in registry.list_archs():
        cfg, jcfg = registry.get(arch), jreg.get(arch)
        for name, shape in shapes.SHAPES.items():
            got = _flat(shapes.input_specs(cfg, shape))
            want = _flat(jshapes.input_specs(jcfg, jshapes.SHAPES[name]))
            assert got.keys() == want.keys(), (arch, name)
            for key, sds in want.items():
                assert got[key].device.type == "meta"
                assert tuple(got[key].shape) == tuple(sds.shape), (arch, name, key)
                assert got[key].dtype == _DTYPES[jnp.dtype(sds.dtype)], (arch, name, key)
                n += 1
        for b, s in ((2, 64), (1, 524288)):
            got = _flat(shapes.decode_cache_specs(cfg, b, s))
            want = _flat(jshapes.decode_cache_specs(jcfg, b, s))
            assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == \
                {k: (tuple(t.shape), _DTYPES[jnp.dtype(t.dtype)]) for k, t in want.items()}
    assert n > 1000


# --------------------------------------------------------------------------
# argument bytes, port against the reference's specs
# --------------------------------------------------------------------------

SERVE = JD.KVSwapServeConfig(group_size=4, n_select=100, rank=64)
FSDP_ALWAYS = {"llama4-maverick-400b-a17b"}


def _fsdp_spec(spec):
    """The reference dry run's ``_fsdp_spec``, copied (its module cannot be
    imported here)."""
    parts = list(spec)
    if "data" in parts:
        return spec
    for i, p in enumerate(parts):
        if p is None:
            parts[i] = "data"
            return JP(*parts)
    return spec


def _ref_layout(arch, shape_name, mesh):
    """``{path: (leaf, spec)}`` of every argument of the reference's step, as
    its ``build_train`` / ``build_prefill`` / ``build_decode`` lay them out."""
    cfg, shape = jreg.get(arch), jshapes.SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    dp = JSP.batch_axes(mesh)
    whisper = jreg.is_whisper(cfg)
    kv = shape.kind == "decode" and (whisper or any(
        k in ("attn", "moe_attn", "shared_attn") for k in cfg.blocks))
    fsdp = shape.kind == "train" or arch in FSDP_ALWAYS

    def make_params(k):
        p = jreg.init_params(k, cfg, jnp.bfloat16)
        return JD.attach_kvswap_adapters(k, p, cfg, SERVE.rank, jnp.bfloat16) if kv else p

    params = jax.eval_shape(make_params, jax.random.PRNGKey(0))
    pspec = JSP.param_pspecs(params, mesh)
    if fsdp:
        pspec = jax.tree_util.tree_map(_fsdp_spec, pspec, is_leaf=lambda x: isinstance(x, JP))
        pspec = jax.tree_util.tree_map(lambda sp, leaf: JSP.sanitize_spec(sp, leaf.shape, mesh),
                                       pspec, params, is_leaf=lambda x: isinstance(x, JP))
    sds = jax.ShapeDtypeStruct
    if shape.kind == "train":
        opt = jax.eval_shape(j_adamw_init, params)
        batch = {"tokens": sds((b, s), jnp.int32), "targets": sds((b, s), jnp.int32)}
        bspec = {"tokens": JP(dp, None), "targets": JP(dp, None)}
        if whisper:
            batch["frames"] = sds((b, cfg.enc_frames, cfg.d_model), jnp.bfloat16)
            bspec["frames"] = JP(dp, None, None)
        trees = {"params": (params, pspec), "opt": (opt, type(opt)(JP(), pspec, pspec)),
                 "batch": (batch, bspec)}
    else:
        decode = shape.kind == "decode"
        shard_seq = decode and b == 1
        cache = jax.eval_shape(lambda: JD.init_cache(cfg, b, s, dtype=jnp.bfloat16,
                                                     kvswap=SERVE if kv else None))
        cspec = JSP.cache_pspecs(cfg, mesh, shard_seq=shard_seq, kvswap=kv)
        tok = sds((b, 1 if decode else s), jnp.int32)
        trees = {"params": (params, pspec), "tokens": (tok, JP() if shard_seq else JP(dp, None)),
                 "cache": (cache, cspec)}
        if whisper:
            trees["enc"] = (sds((b, cfg.enc_frames, cfg.d_model), jnp.bfloat16),
                            JP(None if shard_seq else dp, None, None))
    out = {}
    for name, (tree, spec) in trees.items():
        leaves, specs = _flat(tree), _flat(spec)
        assert leaves.keys() == specs.keys(), name
        out.update({f"{name}/{k}": (leaves[k], specs[k]) for k in leaves})
    return out


def _local_bytes(shape, dtype_bytes, spec, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    shape = list(shape)
    for i, p in enumerate(spec):
        for n in (() if p is None else (p,) if isinstance(p, str) else p):
            assert shape[i] % sizes[n] == 0
            shape[i] //= sizes[n]
    return int(np.prod(shape)) * dtype_bytes


def _port_dtype(path: str, leaf):
    """The dtype the port gives a leaf of the reference's arguments, where
    they differ on purpose: ``None`` for the cache's ``length`` (a host int
    in the port, :mod:`repro_torch.serving.decode`), and bfloat16 for the
    reference's float32 weights — its ``dense_init`` and MoE init multiply
    a bfloat16 draw by a numpy float64 scale, which promotes them — and
    their AdamW moments.  Everything else keeps the reference's dtype."""
    if path.endswith("cache/length"):
        return None
    if jnp.dtype(leaf.dtype) == jnp.float32:
        assert path.split("/")[0] in ("params", "opt"), path
        assert path.split("/")[-1] in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                                       "lm_head", "in_proj", "out_proj", "w_if", "w_x", "w_h",
                                       "router"), path
        return jnp.bfloat16
    return leaf.dtype


def _expected_port_bytes(arch, shape_name, mesh):
    """(the reference's argument bytes per rank, the same with the port's
    dtypes of :func:`_port_dtype`)."""
    ref = port = 0
    for path, (leaf, spec) in _ref_layout(arch, shape_name, mesh).items():
        ref += _local_bytes(leaf.shape, jnp.dtype(leaf.dtype).itemsize, spec, mesh)
        dt = _port_dtype(path, leaf)
        if dt is not None:
            port += _local_bytes(leaf.shape, jnp.dtype(dt).itemsize, spec, mesh)
    return ref, port


@pytest.fixture(scope="module")
def fake_worlds():
    """Port-side argument bytes of every (arch × shape × mesh), laid out by
    the dry run's builders over the fake 256- and 512-rank worlds (nothing
    runs: the args are fake shards)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_world, make_fake_production_mesh

    out = {}
    for name, multi_pod in (("16x16", False), ("2x16x16", True)):
        with fake_world(512 if multi_pod else 256):
            mesh = make_fake_production_mesh(multi_pod=multi_pod)
            for arch in registry.list_archs():
                cfg = registry.get(arch)
                for shape_name, shape in shapes.SHAPES.items():
                    with FakeTensorMode():
                        _, args, specs, _ = DR.build_step(
                            cfg, shape, mesh, fsdp=arch in DR.FSDP_ALWAYS,
                            kvswap=shape.kind == "decode" and DR.uses_kvswap(cfg))
                        out[arch, shape_name, name] = DR.local_bytes(
                            DR.local_shards(args, specs, mesh))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_match_reference_specs(fake_worlds, mesh_name):
    for arch in registry.list_archs():
        for shape_name in shapes.SHAPES:
            ref, want = _expected_port_bytes(arch, shape_name, MESHES[mesh_name])
            assert fake_worlds[arch, shape_name, mesh_name] == want, (arch, shape_name, ref)


def test_llama_decode_argument_bytes_pinned(fake_worlds):
    """The reference's dry run reports 37,380,038,692 argument bytes for
    llama3-8b × decode_32k × 16x16 (JAX 0.9.0 on placeholder CPUs); the
    port holds that less the named leaves: 938,082,304 bytes of float32
    weights held in bfloat16 and the 4-byte ``length``."""
    ref, want = _expected_port_bytes("llama3-8b", "decode_32k", MESHES["16x16"])
    assert ref == 37_380_038_692
    assert ref - want == 938_082_304 + 4
    assert fake_worlds["llama3-8b", "decode_32k", "16x16"] == want == 36_441_956_384
