"""Port kernels (``repro_torch.kernels``) against the JAX reference kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version to the reference Pallas kernels (interpret mode) and to the
``kernels/ref.py`` oracles on the same seeded numpy inputs, over the shape
sweeps of ``tests/test_kernels.py``.  The CUDA kernels themselves run only
on a card: ``tests/test_torch_cuda.py`` compares them with the plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as jpred
from repro.kernels import fused_predict_pallas, ref
from repro.kernels import ops as jops
from repro_torch.core import predictor as tpred
from repro_torch.kernels import _build, ops
from repro_torch.kernels.fused_predict import fused_predict

# fp32 on both sides, sums taken in another order (XLA vs PyTorch CPU): the
# reference suite's own kernel tolerance, far above the ~1e-6 relative
# rounding of sums of <= 2048 products of O(1) values
SCORE_ATOL = 1e-4
# attention outputs are convex combinations of O(1) values: rounding of
# the softmax and of <= 1024-term sums stays well below 1e-5
ATTN_ATOL = 1e-5

SCORE_SHAPES = [(1, 4, 16, 64, 4), (2, 8, 32, 512, 4), (3, 16, 64, 1000, 4),
                (1, 4, 16, 130, 8), (2, 32, 8, 256, 16),
                (2, 4, 512, 300, 4)]       # rank 512 (Llama-3.1-8B's tuned rank), 2048 products
ATTN_SHAPES = [(1, 4, 4, 32, 64), (2, 8, 2, 64, 300), (2, 16, 8, 128, 513),
               (1, 32, 8, 128, 1024), (1, 20, 20, 64, 96), (2, 32, 8, 160, 300)]


def _score_inputs(seed, b, h, r, n):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, r)).astype(np.float32)
    k = rng.standard_normal((b, n, r)).astype(np.float32)
    vl = rng.integers(1, n + 1, b).astype(np.int32)
    return q, k, vl


class TestLowrankGroupScores:
    @pytest.mark.parametrize("b,h,r,n,g", SCORE_SHAPES)
    def test_plain_matches_pallas_and_oracle(self, b, h, r, n, g):
        q, k, vl = _score_inputs(0, b, h, r, n)
        got = ops.lowrank_group_scores(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(vl), group_size=g).numpy()
        pallas = np.asarray(jops.lowrank_group_scores(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(vl), group_size=g,
                                                      interpret=True))
        n_pad = -(-n // g) * g
        oracle = np.asarray(ref.lowrank_group_scores_ref(
            jnp.asarray(q), jnp.pad(jnp.asarray(k), ((0, 0), (0, n_pad - n), (0, 0))),
            jnp.asarray(vl), g))
        assert got.shape == pallas.shape == oracle.shape == (b, n_pad // g)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=SCORE_ATOL)
        # masked groups are exactly -1e30 on both sides
        np.testing.assert_array_equal(got <= -1e29, oracle <= -1e29)

    def test_valid_len_zero_all_masked(self):
        got = ops.lowrank_group_scores(torch.ones(1, 2, 8), torch.ones(1, 64, 8),
                                       torch.zeros(1, dtype=torch.int32), group_size=4)
        assert float(got.max()) <= -1e29

    def test_cpu_path_builds_nothing(self, monkeypatch):
        def refuse(name):
            raise AssertionError("the CPU path must not build or load a kernel")

        monkeypatch.setattr(_build, "load", refuse)
        before = (ops.lowrank_group_scores.launches, ops.gather_attention.launches)
        ops.lowrank_group_scores(torch.ones(1, 2, 8), torch.ones(1, 8, 8),
                                 torch.full((1,), 8, dtype=torch.int32), group_size=4)
        ops.gather_attention(torch.ones(1, 2, 4), torch.ones(1, 3, 1, 4),
                             torch.ones(1, 3, 1, 4), torch.ones(1, 3, dtype=torch.bool))
        # launches count kernel launches only, never the plain version
        assert (ops.lowrank_group_scores.launches, ops.gather_attention.launches) == before


class TestGatherAttention:
    @pytest.mark.parametrize("b,h,hk,d,s", ATTN_SHAPES)
    def test_plain_matches_pallas_and_oracle(self, b, h, hk, d, s):
        rng = np.random.default_rng(1)
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
        v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
        mask = rng.random((b, s)) > 0.3
        got = ops.gather_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
        pallas = np.asarray(jops.gather_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), jnp.asarray(mask),
                                                  interpret=True))
        oracle = np.asarray(ref.gather_attention_ref(
            jnp.asarray(q), jnp.asarray(k).transpose(0, 2, 1, 3),
            jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(mask)))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=ATTN_ATOL)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=ATTN_ATOL)

    def test_fully_masked_row_is_zero(self):
        rng = np.random.default_rng(2)
        q = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((2, 5, 2, 8)).astype(np.float32))
        mask = torch.tensor([[False] * 5, [True] * 5])
        out = ops.gather_attention(q, k, k, mask)
        assert torch.isfinite(out).all()
        assert float(out[0].abs().max()) == 0.0


class TestFusedPredict:
    @pytest.mark.parametrize("b,h,hk,d,r,n,g,m", [
        (2, 4, 2, 16, 8, 64, 4, 6),
        (3, 8, 2, 32, 16, 256, 4, 20),
        (2, 32, 8, 128, 64, 512, 4, 100),   # Llama-3.1-8B widths, short cache
    ])
    def test_ids_and_mask_equal_pallas(self, b, h, hk, d, r, n, g, m):
        rng = np.random.default_rng(3)
        q = rng.standard_normal((b, h, d)).astype(np.float32)
        a = rng.standard_normal((hk, d, r)).astype(np.float32)
        k_lr = rng.standard_normal((b, n, r)).astype(np.float32)
        vl = np.array([n - 8 * i for i in range(b)], np.int32)
        ids, mask = fused_predict(torch.from_numpy(q), torch.from_numpy(a),
                                  torch.from_numpy(k_lr), torch.from_numpy(vl),
                                  group_size=g, n_select=m)
        jids, jmask = fused_predict_pallas(jnp.asarray(q), jnp.asarray(a), jnp.asarray(k_lr),
                                           jnp.asarray(vl), group_size=g, n_select=m,
                                           interpret=True)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        # and the op-by-op composition of the predictor agrees with the reference's
        pids, pmask = tpred.fused_predict(torch.from_numpy(q), torch.from_numpy(a),
                                          torch.from_numpy(k_lr), torch.from_numpy(vl),
                                          group_size=g, n_select=m)
        rids, rmask = jpred.fused_predict(jnp.asarray(q), jnp.asarray(a), jnp.asarray(k_lr),
                                          jnp.asarray(vl), group_size=g, n_select=m)
        np.testing.assert_array_equal(pids.numpy(), np.asarray(rids))
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(rmask))

    def test_ties_pick_the_lower_index_first(self):
        gs = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -1e30, 1.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
        ids, mask = tpred.select_groups(torch.from_numpy(gs), 4)
        _, jids = jax.lax.top_k(jnp.asarray(gs), 4)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(ids.numpy(), [[1, 2, 4, 3], [0, 1, 2, 3]])
        assert mask.all()

    def test_masked_selections_are_zero(self):
        gs = torch.tensor([[2.0, -1e30, -1e30, 1.0]])
        ids, mask = tpred.select_groups(gs, 3)
        assert mask.tolist() == [[True, True, False]]
        assert ids.tolist() == [[0, 3, 0]]


class TestNoFallback:
    """A tensor that is not on the CPU never reaches a plain version."""

    def test_other_devices_raise(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("plain version reached for a non-CPU tensor")

        monkeypatch.setattr(ops, "lowrank_group_scores_plain", refuse)
        monkeypatch.setattr(ops, "gather_attention_plain", refuse)
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            ops.lowrank_group_scores(torch.empty(1, 2, 8, **meta), torch.empty(1, 8, 8, **meta),
                                     torch.empty(1, dtype=torch.int32, **meta), group_size=4)
        with pytest.raises(ValueError, match="CUDA"):
            ops.gather_attention(torch.empty(1, 2, 4, **meta), torch.empty(1, 3, 1, 4, **meta),
                                 torch.empty(1, 3, 1, 4, **meta),
                                 torch.empty(1, 3, dtype=torch.bool, **meta))
