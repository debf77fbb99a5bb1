"""The port's data pipeline (``data/pipeline.py``), checkpoints
(``checkpoint/io.py``) and tree sizes (``utils/treeops.py``) against the JAX
package's.

The data is numpy in both packages: the same seed must give byte-equal
arrays.  Checkpoints share one format, so a file written by either package
loads in the other, bit for bit; ``load_pytree`` rebuilds into the
template's structure, dtype and device.  Sizes are integers and compare
exactly.
"""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload, save_pytree as jsave
from repro.configs import registry as jreg
from repro.data import NeedleTask as JNeedle, SyntheticLMStream as JStream
from repro.data import calib_k_cache as jcalib, make_needle_prompt as jneedle
from repro.utils import tree_bytes as jtree_bytes, tree_count as jtree_count
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import registry
from repro_torch.data import NeedleTask, SyntheticLMStream, calib_k_cache, make_needle_prompt
from repro_torch.training.optim import AdamWState, adamw_init
from repro_torch.training.train import TrainState
from repro_torch.utils import tree_bytes, tree_count


@pytest.mark.parametrize("order,copy_prob", [(1, 0.1), (3, 0.3)])
def test_stream_matches_reference(order, copy_prob):
    for step in (0, 7):
        got = SyntheticLMStream(97, seed=5, order=order, copy_prob=copy_prob).batch(step, 4, 33)
        want = JStream(97, seed=5, order=order, copy_prob=copy_prob).batch(step, 4, 33)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("depth", [0.0, 0.37, 1.0])
def test_needle_matches_reference(depth):
    got = make_needle_prompt(1000, 256, depth=depth, needle_len=6, seed=3)
    want = jneedle(1000, 256, depth=depth, needle_len=6, seed=3)
    assert isinstance(got, NeedleTask) and isinstance(want, JNeedle)
    assert got.tokens.tobytes() == want.tokens.tobytes()
    assert (got.needle_start, got.needle_len, got.query_start) == \
        (want.needle_start, want.needle_len, want.query_start)
    assert got.needle_span == want.needle_span


def test_calib_k_cache_takes_tensors():
    k = np.random.default_rng(0).standard_normal((2, 5, 3, 4)).astype(np.float32)
    tokens = np.zeros((2, 5), np.int32)
    got = calib_k_cache(lambda t: torch.from_numpy(k), tokens)
    assert got.tobytes() == jcalib(lambda t: jnp.asarray(k), tokens).tobytes()
    assert got.shape == (10, 3, 4)


def pair(arch="zamba2-1.2b"):
    jp = jreg.init_params(jax.random.PRNGKey(0), jreg.smoke(arch))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_checkpoint_roundtrip(tmp_path):
    """Params, and a ``TrainState`` with its ``AdamWState`` and a ``None``
    leaf, back into fresh templates: equal bits, the template's dtype, named
    tuples kept, no ``.tmp`` left behind."""
    _, tp = pair()
    path = os.path.join(tmp_path, "sub", "ck.npz")
    save_pytree(path, tp)
    tmpl = registry.init_params(registry.smoke("zamba2-1.2b"),
                                generator=torch.Generator().manual_seed(1), device="cpu")
    back = load_pytree(path, tmpl)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tp)))
    state = TrainState({"w": torch.randn(3, 2), "none": None}, adamw_init({"w": torch.ones(3, 2)}))
    save_pytree(path, state)
    tmpl = TrainState({"w": torch.zeros(3, 2, dtype=torch.float64), "none": None},
                      adamw_init({"w": torch.zeros(3, 2)}))
    back = load_pytree(path, tmpl)
    assert isinstance(back, TrainState) and isinstance(back.opt, AdamWState)
    assert back.params["none"] is None and back.params["w"].dtype == torch.float64
    assert torch.equal(back.params["w"], state.params["w"].double())
    assert int(back.opt.step) == 0 and back.opt.step.dtype == torch.int32
    assert os.listdir(os.path.dirname(path)) == ["ck.npz"]


def test_checkpoint_keys_equal_the_references(tmp_path):
    jp, tp = pair("olmoe-1b-7b")
    a, b = os.path.join(tmp_path, "port.npz"), os.path.join(tmp_path, "ref.npz")
    save_pytree(a, {"p": tp, "none": None})
    jsave(b, {"p": jp, "none": None})
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert sorted(za.namelist()) == sorted(zb.namelist())
        assert "none#none.npy" in za.namelist() and "p/blocks/0/attn/wq.npy" in za.namelist()


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jp, tp = pair()
    path = os.path.join(tmp_path, "port.npz")
    save_pytree(path, tp)
    back = jload(path, jax.tree_util.tree_map(jnp.zeros_like, jp))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jp, tp = pair("whisper-large-v3")
    path = os.path.join(tmp_path, "ref.npz")
    jsave(path, jp)
    tmpl = registry.init_params(registry.smoke("whisper-large-v3"),
                                generator=torch.Generator().manual_seed(2), device="cpu")
    back = load_pytree(path, tmpl)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tp)))


def test_load_refuses_a_wrong_shape_or_a_missing_key(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    save_pytree(path, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch at w"):
        load_pytree(path, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing v"):
        load_pytree(path, {"w": torch.zeros(3), "v": torch.zeros(1)})


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b", "whisper-large-v3"])
def test_tree_sizes_match_reference(arch):
    jp, tp = pair(arch)
    for jt, tt in ((jp, tp), ({"a": jp, "n": None, "s": 3.0}, {"a": tp, "n": None, "s": 3.0})):
        assert tree_count(tt) == jtree_count(jt) > 0
        assert tree_bytes(tt) == jtree_bytes(jt) > 0
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    assert tree_bytes(np_tree) == jtree_bytes(np_tree)
