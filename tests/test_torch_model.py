"""Port model layers and adapter (``repro_torch.models``) against the JAX
reference, on the reference's own weights loaded through the bridge.

Every comparison is fp32 on both sides; XLA and PyTorch take matrix
products and reductions in different orders, so each tolerance sits above
that rounding (a few ulps times the depth of the sum) and far below any
real mistake (a wrong RoPE convention or mask moves outputs by O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama, qwen3_8b as jqwen
from repro.models import layers as JL
from repro.models.transformer import TransformerAdapter as JAdapter, init_params as jinit
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import llama3_8b, qwen3_8b
from repro_torch.models import layers as TL
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params

RTOL, ATOL = 1e-4, 1e-5


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


CONFIGS = {
    "tiny": None,   # the suite's tiny_cfg fixture
    "llama3-8b-smoke": jllama.smoke_config,
    "qwen3-8b-smoke": jqwen.smoke_config,
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, tiny_cfg):
    make = CONFIGS[request.param]
    cfg = tiny_cfg if make is None else make()
    jp = jinit(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return JAdapter(cfg), jp, TransformerAdapter(port_cfg(cfg)), tp


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_port_configs_equal_reference():
    assert llama3_8b.config() == port_cfg(jllama.config())
    assert llama3_8b.smoke_config() == port_cfg(jllama.smoke_config())
    assert qwen3_8b.config() == port_cfg(jqwen.config())
    assert qwen3_8b.smoke_config() == port_cfg(jqwen.smoke_config())


class TestAdapter:
    def test_embed_and_logits(self, pair):
        ja, jp, ta, tp = pair
        tok = np.random.default_rng(0).integers(0, ja.vocab_size, (2, 7))
        x = ta.embed(tp, torch.from_numpy(tok))
        close(x, ja.embed(jp, jnp.asarray(tok)))
        close(ta.logits(tp, x[:, -1]), ja.logits(jp, jnp.asarray(x.numpy())[:, -1]))

    def test_prefill_block(self, pair):
        ja, jp, ta, tp = pair
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 11, ja.d_model)).astype(np.float32)
        pos = np.tile(np.arange(11), (2, 1))
        got = ta.prefill_block(tp, 1, torch.from_numpy(x), torch.from_numpy(pos))
        want = ja.prefill_block(jp, 1, jnp.asarray(x), jnp.asarray(pos))
        for g, w in zip(got, want):
            close(g, w)

    def test_decode_block_and_predict_query(self, pair):
        ja, jp, ta, tp = pair
        rng = np.random.default_rng(2)
        b, n = 3, 24
        x = rng.standard_normal((b, ja.d_model)).astype(np.float32)
        pos = np.array([30, 41, 57], np.int32)
        k = rng.standard_normal((b, n, ja.n_kv_heads, ja.head_dim)).astype(np.float32)
        v = rng.standard_normal((b, n, ja.n_kv_heads, ja.head_dim)).astype(np.float32)
        mask = rng.random((b, n)) > 0.4
        got = ta.decode_block(tp, 0, *(torch.from_numpy(a) for a in (x, pos, k, v, mask)))
        want = ja.decode_block(jp, 0, *(jnp.asarray(a) for a in (x, pos, k, v, mask)))
        for g, w in zip(got, want):
            close(g, w)
        close(ta.predict_query(tp, 1, torch.from_numpy(x), torch.from_numpy(pos)),
              ja.predict_query(jp, 1, jnp.asarray(x), jnp.asarray(pos)))

    def test_gather_context(self, pair):
        ja, _, ta, _ = pair
        rng = np.random.default_rng(3)
        b, c, g, m = 2, 5, 4, 3
        shape = (b, c, g, ja.n_kv_heads, ja.head_dim)
        dk, dv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        slots = np.array([[4, -1, 0], [-2, 2, 1]])
        tk, tv = (rng.standard_normal((b, g, ja.n_kv_heads, ja.head_dim)).astype(np.float32)
                  for _ in range(2))
        fill = np.array([3, 0], np.int32)
        got = ta.gather_context(*(torch.from_numpy(a) for a in (dk, dv, slots, tk, tv, fill)))
        want = ja.gather_context(*(jnp.asarray(a) for a in (dk, dv, slots, tk, tv, fill)))
        for gt, w in zip(got, want):
            np.testing.assert_array_equal(gt.numpy(), np.asarray(w))   # a pure gather
        assert got[0].shape == (b, m * g + g, ja.n_kv_heads, ja.head_dim)


class TestLayers:
    def test_rope_split_halves(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
        pos = rng.integers(0, 4000, (2, 5))
        close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
              JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))

    def test_rmsnorm_and_causal_attention(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 6, 32)).astype(np.float32)
        scale = rng.standard_normal(32).astype(np.float32)
        close(TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
              JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
        q = rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
        k = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
        v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
        close(TL.causal_attention(*(torch.from_numpy(a) for a in (q, k, v))),
              JL.causal_attention(*(jnp.asarray(a) for a in (q, k, v))))


class TestInitParams:
    def test_layout_matches_reference(self, tiny_cfg):
        for cfg in (tiny_cfg, jqwen.smoke_config()):
            want = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                          jinit(jax.random.PRNGKey(0), cfg))
            got = init_params(port_cfg(cfg), generator=torch.Generator().manual_seed(0),
                              device="cpu")
            assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want

    def test_seeded(self, tiny_cfg):
        a, b = (init_params(port_cfg(tiny_cfg), generator=torch.Generator().manual_seed(7),
                            device="cpu") for _ in range(2))
        assert torch.equal(a["blocks"][1]["mlp"]["w_up"], b["blocks"][1]["mlp"]["w_up"])
        # N(0, 1/fan_in) dense weights, as the reference draws them
        w = a["blocks"][0]["mlp"]["w_down"]
        assert abs(float(w.std()) * np.sqrt(tiny_cfg.d_ff) - 1.0) < 0.1

    @pytest.mark.parametrize("kind", ["moe_attn", "shared_attn", "mamba2", "mlstm"])
    def test_other_block_kinds_refused(self, tiny_cfg, kind):
        cfg = dataclasses.replace(port_cfg(tiny_cfg), block_pattern=("attn", kind))
        with pytest.raises(NotImplementedError):
            init_params(cfg, generator=torch.Generator(), device="cpu")
        with pytest.raises(NotImplementedError):
            TransformerAdapter(cfg)
