"""The port's partition rules (``sharding/partition.py``), meshes
(``launch/mesh.py``) and the model's sharding hooks against the JAX
package's.

Specs are compared exactly, as tuples (the port's ``P`` is a tuple of axis
names, ``None`` or tuples of names per dim): ``param_pspecs`` for every
leaf of every registry arch's smoke config, with and without a fake 16×16
mesh's sanitising; ``cache_pspecs`` over ``shard_seq × kvswap × rolling ×
seq_over_model`` on fake 16×16 and 2×16×16 meshes.  ``forward`` on DTensor
params over a one-rank gloo mesh (in this process) must equal the plain
``forward`` within 1e-6 of the largest |logit| (one rank: every shard is the
whole tensor, so the same CPU kernels run on the same values).
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.sharding import partition as JSP
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh_auto, make_production_mesh, make_smoke_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import P, cache_pspecs, distribute_params, param_pspecs, to_placements
from repro_torch.sharding import partition as SP


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


MESH = FakeMesh(("data", "model"), (16, 16))
POD_MESH = FakeMesh(("pod", "data", "model"), (2, 16, 16))


@contextlib.contextmanager
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def flat_specs(tree, path=()):
    """``{"blocks/0/attn/wq": (None, "model"), ...}`` from either package."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_specs(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (P, JP)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_specs(sub, path + (i,)).items()}
    return {"/".join(map(str, path)): tuple(tree)}


@pytest.mark.parametrize("arch", registry.ALL_ARCHS)
def test_param_pspecs_match_reference(arch):
    jcfg = jreg.smoke(arch)
    jparams = jax.eval_shape(lambda: jreg.init_params(jax.random.PRNGKey(0), jcfg))
    params = registry.init_params(registry.smoke(arch), generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    for mesh in (None, MESH):
        want = flat_specs(JSP.param_pspecs(jparams, mesh))
        got = flat_specs(param_pspecs(params, mesh))
        assert got == want
        assert len(got) == len(jax.tree_util.tree_leaves(jparams))


def test_sanitize_spec_cases():
    for spec, shape in [(P("model", None), (51866, 1280)), (P(None, "model"), (2048, 8)),
                        (P(None, "model"), (2048, 1024)), (P(("data", "model"), None), (512, 4)),
                        (P(("data", "model"), None), (100, 4)), (P(None, None, "model"), (4, 8)),
                        (P("data"), (32, 3, 5)), (P(), (7,))]:
        got = SP.sanitize_spec(spec, shape, MESH)
        assert isinstance(got, P)
        assert tuple(got) == tuple(JSP.sanitize_spec(JP(*spec), shape, MESH))
    assert SP.sanitize_spec(P("model", None), (51866, 1280), MESH) == (None, None)
    assert SP.sanitize_spec(P(("data", "model"), None), (512, 4), MESH) == (("data", "model"), None)


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b", "whisper-large-v3", "xlstm-1.3b"])
def test_cache_pspecs_match_reference(arch):
    jcfg, cfg = jreg.smoke(arch), registry.smoke(arch)
    for mesh in (MESH, POD_MESH):
        for shard_seq in (False, True):
            for kvswap in (False, True):
                for rolling in (False, True):
                    for seq_over_model in (False, True):
                        kw = dict(shard_seq=shard_seq, kvswap=kvswap, rolling=rolling,
                                  seq_over_model=seq_over_model)
                        want = JSP.cache_pspecs(jcfg, mesh, **kw)
                        got = cache_pspecs(cfg, mesh, **kw)
                        assert flat_specs(got) == flat_specs(want), kw
    assert SP.batch_axes(POD_MESH) == JSP.batch_axes(POD_MESH) == ("pod", "data")


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert to_placements(POD_MESH, P(None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert to_placements(POD_MESH, P(("pod", "data"), None, "model")) == (Shard(0), Shard(0),
                                                                           Shard(2))
    assert to_placements(MESH, P()) == (Replicate(), Replicate())
    # an axis of size 1 splits nothing: it replicates
    assert to_placements(FakeMesh(("data", "model"), (1, 8)), P("data", "model")) == \
        (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="two dims"):
        to_placements(FakeMesh(("data", "model"), (1, 8)), P("data", "data"))
    with pytest.raises(ValueError, match="order"):
        to_placements(MESH, P(("model", "data")))
    with pytest.raises(ValueError, match="two dims"):
        to_placements(MESH, P("model", "model"))


def test_hooks_are_identity_unset_and_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert T._act_constrain(x) is x and L._moe_constrain("buf", x) is x
    T.set_activation_pspec(P("data", None, None))
    L.set_moe_pspecs({"buf": P("data", "model", None, None), "y": P("data", None, None)})
    try:
        assert T._act_constrain(x) is x and L._moe_constrain("y", x) is x
    finally:
        T.set_activation_pspec(None)
        L.set_moe_pspecs(None)


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_forward_on_distributed_params(tmp_path, arch):
    """``distribute_params`` over a one-rank (1, 1) mesh, with the
    activation and MoE hooks set, and ``forward`` on the DTensors (the plain
    tensors it makes count as replicated) against the plain ``forward``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = registry.smoke(arch)
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    want, want_aux = T.forward(params, cfg, toks)
    with one_rank_group(tmp_path):
        mesh = make_smoke_mesh(device="cpu")
        specs = param_pspecs(params, mesh)
        dparams = distribute_params(params, mesh, specs)
        wq = dparams["blocks"][0]["attn"]["wq"]
        assert isinstance(wq, DTensor) and wq.device_mesh == mesh
        assert wq.placements == to_placements(mesh, specs["blocks"][0]["attn"]["wq"])
        T.set_activation_pspec(P("data", None, None))
        L.set_moe_pspecs({"buf": P("data", "model", None, None), "y": P("data", None, None)})
        try:
            with implicit_replication():
                got, aux = T.forward(dparams, cfg, toks)
            got, aux = got.full_tensor(), (aux.full_tensor() if isinstance(aux, DTensor) else aux)
        finally:
            T.set_activation_pspec(None)
            L.set_moe_pspecs(None)
    big = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-6 * big
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_mesh_needs_a_group_and_the_world(tmp_path):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh_auto((1,), ("data",), device="cpu")
    with one_rank_group(tmp_path):
        with pytest.raises(ValueError, match="the world has 1"):
            make_mesh_auto((2, 1), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            make_mesh_auto((1,), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="holds 256 devices"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="holds 512 devices"):
            make_production_mesh(multi_pod=True, device="cpu")
        mesh = make_smoke_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
