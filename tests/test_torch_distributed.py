"""The port's sequence-sharded decode attention (``serving/distributed.py``
on ``torch.distributed``) against the JAX package's ``reference_decode_attn``.

The ranks run as four gloo processes on the CPU (one spawn, shared by the
four-rank cases below through a module fixture; each rank makes only its
own 64-token shard), and as one rank in this process.  Tolerance: 2e-5
absolute, as ``tests/test_distributed.py`` holds the reference's own
shards to its oracle (fp32 partial softmaxes combined by the
flash-decoding identity against one softmax over every selected token).
The port's oracle on the same inputs is held to the same 2e-5; the ranks'
outputs must be bit-identical to each other.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.serving.distributed import reference_decode_attn as jref_attn
from repro_torch.launch.mesh import make_mesh_auto
from repro_torch.seqshard_path import SeqShardSpec, kv_blocks, replicated_inputs, run_rank, spawn_ranks
from repro_torch.serving import distributed as SD

ATOL = 2e-5
SPEC = SeqShardSpec(b=2, h=8, hk=2, d=16, r=8, n=256, block=64, group_size=4)
CASES = [{"length": 200, "n_select": 16},    # the reference's 4-shard case
         {"length": 100, "n_select": 16},    # shards 2 and 3 wholly past the length
         {"length": 250, "n_select": 100}]   # a quota of 25 over a shard's 16 groups
IDS = ["basic", "shards-past-length", "quota-over-groups"]


@contextlib.contextmanager
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs():
    rep = replicated_inputs(SPEC, "cpu")
    k_lr, k, v = kv_blocks(SPEC, 0, SPEC.n // SPEC.block, rep["a"])
    return (rep["q"], rep["q_lr"], k_lr, k, v, rep["k_new"], rep["v_new"])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn_ranks(SPEC, CASES, world=4, workdir=tmp_path_factory.mktemp("seqshard"),
                       device="cpu", timeout=120)


def jax_ref(inputs, case, n_shards):
    args = [jnp.asarray(t.numpy()) for t in inputs]
    return np.asarray(jref_attn(*args, jnp.int32(case["length"]), group_size=SPEC.group_size,
                                n_select=case["n_select"], n_shards=n_shards))


def oracle(inputs, case, n_shards):
    return SD.reference_decode_attn(*inputs, case["length"], group_size=SPEC.group_size,
                                    n_select=case["n_select"], n_shards=n_shards)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_four_ranks_match_oracle_and_reference(four_ranks, inputs, i):
    got = four_ranks[0][i]["out"]
    np.testing.assert_allclose(got.numpy(), jax_ref(inputs, CASES[i], 4), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle(inputs, CASES[i], 4).numpy(), rtol=0,
                               atol=ATOL)


def test_four_ranks_agree(four_ranks):
    """Every rank ends with the same bits; on the CPU kernel A's plain
    version runs (no launch), and no selection differs from it."""
    for i in range(len(CASES)):
        outs = [r[i]["out"] for r in four_ranks]
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert [r[i]["launches"] for r in four_ranks] == [0] * 4
        assert all(r[i]["flips"] == [] for r in four_ranks)


def test_world_one_matches_oracle_and_reference(tmp_path, inputs):
    with one_rank_group(tmp_path):
        mesh = make_mesh_auto((1,), ("data",), device="cpu")
        res = run_rank(SPEC, mesh, CASES, device="cpu", reps=2)
    for case, r in zip(CASES, res):
        np.testing.assert_allclose(r["out"].numpy(), jax_ref(inputs, case, 1), rtol=0, atol=ATOL)
        assert torch.equal(r["out"], oracle(inputs, case, 1))
        assert len(r["step_ms"]) == 2 and r["combine_bytes"] == 4 * SPEC.b * SPEC.h * (SPEC.d + 2)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_oracle_matches_reference(inputs, n_shards):
    for case in CASES:
        np.testing.assert_allclose(oracle(inputs, case, n_shards).numpy(),
                                   jax_ref(inputs, case, n_shards), rtol=0, atol=ATOL)


def test_shard_select_matches_top_k():
    """Ties rank the lower group first and masked groups are invalid, as
    ``jax.lax.top_k`` with the reference's ``> NEG / 2`` test."""
    rng = np.random.default_rng(3)
    gsc = rng.integers(0, 4, (3, 40)).astype(np.float32)     # many ties
    gsc[1, 10:] = SD.NEG
    gsc[2] = SD.NEG
    for quota in (5, 40, 60):
        gids, valid = SD.shard_select(torch.from_numpy(gsc), quota)
        top, want = jax.lax.top_k(jnp.asarray(gsc), min(quota, 40))
        np.testing.assert_array_equal(gids.numpy(), np.asarray(want))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(top) > SD.NEG / 2)


def test_attention_refuses_other_kv_heads(tmp_path, inputs):
    with one_rank_group(tmp_path):
        mesh = make_mesh_auto((1,), ("data",), device="cpu")
        attn = SD.make_seqshard_decode_attn(mesh, group_size=4, n_select=8, n_kv_heads=4)
        with pytest.raises(ValueError, match="KV heads"):
            attn(*inputs, 100)
