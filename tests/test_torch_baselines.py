"""The port's baselines (``repro_torch.core.baselines``, paper §4.2) and the
rest of its low-rank adapter and predictor against the JAX package's.

The baselines are numpy on both sides: every policy's ``Selection`` is
held equal over a sequence of decode steps (the reuse state included), and
``evaluate_policy`` and ``simulate_throughput`` to 1e-9 relative.  The
low-rank helpers: ``reconstruction_error`` (numpy float64 on both sides) to
1e-12, ``append_compressed`` to 1e-6.  The predictor's ``predict_groups``
and ``exact_group_scores`` give equal group ids and scores within 1e-5
(fp32 products summed in another order), and ``recall_at_m`` equal recalls.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB, hardware as jhw, lowrank as JLR, predictor as JP
from repro.core.offload import DISKS as JDISKS
from repro_torch.core import PredictorConfig, baselines as B, hardware, predict_groups
from repro_torch.core import lowrank as LR, predictor as P
from repro_torch.core.offload import DISKS
from repro_torch.main_path import baseline_policies

HK, D, H = 4, 32, 16
RTOL = 1e-9


def cache(seed, n=300, hk=HK, d=D, h=H, structured=True):
    """Query, K and V of one row: K locally coherent (the simulator's AR(1)
    over tokens) so that grouped selection has structure to find."""
    rng = np.random.default_rng(seed)
    k = np.empty((n, hk, d), np.float32)
    prev = rng.standard_normal((hk, d))
    for t in range(n):
        prev = 0.7 * prev + np.sqrt(1 - 0.49) * rng.standard_normal((hk, d))
        k[t] = prev if structured else rng.standard_normal((hk, d))
    q = rng.standard_normal((h, d)).astype(np.float32)
    v = rng.standard_normal((n, hk, d)).astype(np.float32)
    return q, k, v


CALIB = cache(99, n=512)[1]
POLICIES = {
    "flexgen": lambda m: m.FlexGenPolicy(HK, D),
    "infinigen": lambda m: m.InfiniGenPolicy(HK, D),
    "infinigen*": lambda m: m.InfiniGenPolicy(HK, D, head_agg=True),
    "infinigen*+ru": lambda m: m.InfiniGenPolicy(HK, D, head_agg=True, reuse=True, seed=3),
    "shadowkv": lambda m: m.ShadowKVPolicy(HK, D, rank=24),
    "shadowkv+ru": lambda m: m.ShadowKVPolicy(HK, D, reuse=True),
    "loki": lambda m: m.LokiPolicy(HK, D),
    "loki-calib": lambda m: m.LokiPolicy(HK, D, rank=16, calib=CALIB),
    "kvswap": lambda m: m.KVSwapPolicy(HK, D, group_size=4, rank=16),
    "kvswap-calib": lambda m: m.KVSwapPolicy(HK, D, group_size=8, rank=32, calib=CALIB,
                                             reuse=False),
    "kvswap-int8": lambda m: m.KVSwapPolicy(HK, D, kv_bytes=1),
}


def same_selection(got, want):
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    assert (got.io_bytes, got.io_requests, got.mem_bytes) == \
        (want.io_bytes, want.io_requests, want.mem_bytes)


def close_dict(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, str):
            assert got[key] == w
        else:
            np.testing.assert_allclose(got[key], w, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_matches_reference(name):
    """Selections over drifting queries (the reuse state carries across
    steps), then ``evaluate_policy`` and ``simulate_throughput``."""
    got_p, want_p = POLICIES[name](B), POLICIES[name](JB)
    assert got_p.name == want_p.name
    q, k, v = cache(1)
    rng = np.random.default_rng(2)
    for p in (got_p, want_p):
        p.reset(k.shape[0])
    for _ in range(4):
        q = (0.9 * q + 0.4 * rng.standard_normal(q.shape)).astype(np.float32)
        same_selection(got_p.select(q, k, 64), want_p.select(q, k, 64))
    np.testing.assert_array_equal(got_p.effective_k(k), want_p.effective_k(k))
    close_dict(dataclasses.asdict(B.evaluate_policy(POLICIES[name](B), q, k, v, 48)),
               dataclasses.asdict(JB.evaluate_policy(POLICIES[name](JB), q, k, v, 48)))
    dims = dict(d_model=512, n_heads=H, n_kv_heads=HK, head_dim=D, d_ff=1024)
    kw = dict(n_layers=4, batch=2, n_ctx=256, budget_tokens=64, n_steps=6, seed=5)
    close_dict(B.simulate_throughput(POLICIES[name](B), disk=DISKS["ufs"],
                                     dims=hardware.ModelDims(**dims), **kw),
               JB.simulate_throughput(POLICIES[name](JB), disk=JDISKS["ufs"],
                                      dims=jhw.ModelDims(**dims), **kw))


def test_attention_helpers_match_reference():
    q, k, v = cache(3, structured=False)
    ids = np.sort(np.random.default_rng(4).choice(k.shape[0], 50, replace=False))
    np.testing.assert_array_equal(B.head_scores(q, k), JB.head_scores(q, k))
    np.testing.assert_array_equal(B.attention_output(q, k, v, ids),
                                  JB.attention_output(q, k, v, ids))
    assert B.attention_mass(q, k, ids) == JB.attention_mass(q, k, ids)
    assert 0.0 < B.attention_mass(q, k, ids) < 1.0


def test_baseline_policies_of_the_main_path():
    """``main_path.baseline_policies``: the six of the paper's comparison,
    KVSwap at the engine's group size and rank; FlexGen reads every token."""
    pols = baseline_policies(HK, D, group_size=8, rank=24)
    assert [p.name for p in pols] == ["flexgen", "infinigen", "infinigen*", "shadowkv",
                                      "loki", "kvswap"]
    assert (pols[-1].g, pols[-1].rank) == (8, 24)
    q, k, v = cache(6)
    res = B.evaluate_policy(pols[0], q.astype(np.float64), k.astype(np.float64),
                            v.astype(np.float64), 40)
    assert res.recall == 1.0 and res.out_err == 0.0 and abs(res.mass - 1.0) < 1e-12


# -- the rest of the low-rank adapter ----------------------------------------

def test_lowrank_helpers_match_reference():
    k = cache(7, n=200)[1]
    got = LR.fit_adapter(k, rank=24, device="cpu")
    want = JLR.fit_adapter(k, rank=24)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), rtol=0, atol=1e-6)
    assert got.sigma == want.sigma == HK * D / 24
    assert got.nbytes() == want.nbytes() == HK * D * 24 * 4
    for kk in (k, k.reshape(4, 50, HK, D), cache(8, n=64)[1]):
        np.testing.assert_allclose(LR.reconstruction_error(kk, got),
                                   JLR.reconstruction_error(kk, want), rtol=1e-12)
    full = LR.fit_adapter(k, rank=HK * D, device="cpu")
    assert LR.reconstruction_error(k, full) < 1e-6


def test_append_compressed_matches_reference():
    k = cache(9, n=64)[1]
    got_a, want_a = LR.fit_adapter(k, rank=16, device="cpu"), JLR.fit_adapter(k, rank=16)
    rng = np.random.default_rng(10)
    k_lr = rng.standard_normal((2, 12, 16)).astype(np.float32)
    new_k = rng.standard_normal((2, 4, HK, D)).astype(np.float32)
    got = LR.append_compressed(torch.from_numpy(k_lr), torch.from_numpy(new_k), got_a)
    want = JLR.append_compressed(jnp.asarray(k_lr), jnp.asarray(new_k), want_a)
    assert got.shape == (2, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(got[:, :12], torch.from_numpy(k_lr))


# -- the rest of the predictor -----------------------------------------------

def predictor_inputs(seed, b=2, n=64, d_model=48, r=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d_model)).astype(np.float32)
    wq = (rng.standard_normal((d_model, H * D)) / np.sqrt(d_model)).astype(np.float32)
    k = rng.standard_normal((b, n, HK, D)).astype(np.float32)
    a = np.array(JLR.fit_adapter(k.reshape(-1, HK, D), rank=r).a)
    k_lr = (k.reshape(b, n, -1) @ a).astype(np.float32)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    return x, wq, a, k_lr, k, q


@pytest.mark.parametrize("valid", [[64, 64], [64, 30], [9, 0]], ids=["full", "ragged", "short"])
def test_predict_groups_matches_reference(valid):
    x, wq, a, k_lr, _, _ = predictor_inputs(11)
    got = predict_groups(*map(torch.from_numpy, (x, wq, a, k_lr)),
                         torch.tensor(valid), PredictorConfig(4, 6, H, HK))
    want = JP.predict_groups(*map(jnp.asarray, (x, wq, a, k_lr)), jnp.asarray(valid),
                             JP.PredictorConfig(4, 6, H, HK))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert PredictorConfig(4, 6, H, HK).heads_per_kv == H // HK
    # the op-by-op pieces under it
    adapter = LR.LowRankAdapter(a=torch.from_numpy(a), n_kv_heads=HK, head_dim=D)
    q = torch.from_numpy(x) @ torch.from_numpy(wq)
    q_lr = P.lowrank_queries(q.reshape(2, H, D), adapter)
    want_lr = JP.lowrank_queries(jnp.asarray(q.numpy().reshape(2, H, D)),
                                 JLR.LowRankAdapter(jnp.asarray(a), HK, D), H)
    np.testing.assert_allclose(q_lr.numpy(), np.asarray(want_lr), rtol=1e-5, atol=1e-5)


def test_exact_group_scores_and_recall_match_reference():
    _, _, a, k_lr, k, q = predictor_inputs(12)
    for valid in (None, 64, [64, 37]):
        vt = None if valid is None else torch.as_tensor(valid)
        vj = None if valid is None else jnp.asarray(valid)
        got = P.exact_group_scores(torch.from_numpy(q), torch.from_numpy(k), 4, vt)
        want = JP.exact_group_scores(jnp.asarray(q), jnp.asarray(k), 4, vj)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(P.select_groups(got, 6)[0].numpy(),
                                      np.asarray(JP.select_groups(want, 6)[0]))
    oracle, mask = P.select_groups(P.exact_group_scores(
        torch.from_numpy(q), torch.from_numpy(k), 4), 6)
    adapter = LR.LowRankAdapter(a=torch.from_numpy(a), n_kv_heads=HK, head_dim=D)
    pred, _ = P.fused_predict(torch.from_numpy(q), adapter.per_head, torch.from_numpy(k_lr),
                              torch.tensor([64, 64]), group_size=4, n_select=6)
    rec = P.recall_at_m(pred, oracle, mask)
    assert rec == JP.recall_at_m(jnp.asarray(pred.numpy()), jnp.asarray(oracle.numpy()),
                                 jnp.asarray(mask.numpy()))
    assert 0.0 <= rec <= 1.0
    assert P.recall_at_m(oracle, oracle, mask) == 1.0
    assert P.recall_at_m(pred.numpy(), oracle.numpy(), np.zeros((2, 6), bool)) == 0.0
