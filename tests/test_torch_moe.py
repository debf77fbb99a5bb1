"""The port's MoE (``layers.moe``, the ``moe_attn`` block kind) and the configs
it brings (OLMoE-1B-7B, Llama-4-Maverick and the four dense ones) against
the JAX package, on the reference's weights through the bridge.

The layer: ``y`` and the load-balance loss within 1e-5, with tokens dropped
past an expert's capacity (the drop order follows the token-major, then
rank, flattening of the assignments), with the shared expert, with equal
router probabilities (the lower expert first, as ``jax.lax.top_k``) and at
a decode step's S = 1.  The model: ``forward``, the adapter's blocks, cold
and warm prefill, ``KVSwapEngine.generate`` and ``ServeSession`` on the
two MoE smoke configs, with the tolerances of ``test_torch_model.py``
(blocks, 1e-4 relative and 1e-5 absolute) and ``test_torch_engine.py``
(engine logits within 1e-4; equal tokens and per-layer selections, with
its near-tie gap check at every step).

An MoE call's capacity depends on its own length, so a warm prefill (only
the suffix routed) equals the cold one only where no token drops, in the
reference as in the port: the port's warm prefill is held to the
reference's warm prefill, and the port's warm == cold bit-identity only at
a capacity factor that drops nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.configs import registry as jreg
from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.models import layers as JL
from repro.models.transformer import (TransformerAdapter as JAdapter, forward as jforward,
                                      init_params as jinit)
from repro.serving.api import ServeSession as JSession
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.configs import registry
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.launch import serve
from repro_torch.main_path import probe_fidelity, run_main_path, tuned_engine_config
from repro_torch.models import layers as L
from repro_torch.models.transformer import (ModelConfig, TransformerAdapter, block_forward,
                                           forward, init_params)
from repro_torch.serving import ServeSession
from test_torch_engine import record

RTOL, ATOL, LOGIT_TOL = 1e-4, 1e-5, 1e-4
MOE_TOL = 1e-5
CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128)
MOE_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
NEW_ARCHS = ("olmoe-1b-7b", "stablelm-12b", "qwen3-32b", "granite-8b", "chameleon-34b",
             "llama4-maverick-400b-a17b")


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    """``(reference cfg, reference adapter, reference params, port adapter,
    port params, calibration K)`` of an MoE smoke config."""
    cfg = jreg.smoke(request.param)
    jp = jinit(jax.random.PRNGKey(2), cfg)
    calib = np.random.default_rng(11).standard_normal(
        (256, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    return cfg, JAdapter(cfg), jp, TransformerAdapter(port_cfg(cfg)), to_torch(jp), calib


# -- the layer ---------------------------------------------------------------

def dropped(p, x, top_k, cf) -> int:
    """Assignments past their expert's capacity, by the reference's routing."""
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, top_k)[1]).reshape(x.shape[0], -1)
    cap = L.moe_capacity(x.shape[1], top_k, p["router"].shape[1], cf)
    return sum(max(0, c - cap) for row in idx for c in np.bincount(row))


MOE_CASES = {   # (d_model, d_ff, experts, top_k, shared, capacity factor, S, zero router)
    "top2": (32, 48, 4, 2, 0, 1.25, 16, False),
    "drops": (32, 48, 8, 2, 0, 0.5, 40, False),
    "shared": (32, 48, 4, 1, 24, 1.25, 12, False),
    "ties": (16, 24, 6, 2, 0, 1.25, 9, True),
    "decode": (32, 48, 8, 4, 16, 1.25, 1, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_reference(case):
    d, f, e, k, shared, cf, s, zero = MOE_CASES[case]
    p = JL.init_moe(jax.random.PRNGKey(3), d_model=d, d_ff=f, n_experts=e, shared_d_ff=shared)
    if zero:    # every probability equal: the top k are the lowest experts
        p["router"] = jnp.zeros_like(p["router"])
    x = np.random.default_rng(4).standard_normal((3, s, d)).astype(np.float32)
    want_y, want_aux = JL.moe(p, jnp.asarray(x), top_k=k, capacity_factor=cf)
    got_y, got_aux = L.moe(to_torch(p), torch.from_numpy(x), top_k=k, capacity_factor=cf)
    close(got_y, want_y, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=MOE_TOL)
    assert L.moe_capacity(s, k, e, cf) == max(1, int(np.ceil(s * k / e * cf)))
    if case in ("drops", "ties"):
        assert dropped(p, x, k, cf) > 0, "no token dropped: the case proves nothing"


def test_init_moe_layout_and_scales():
    for arch in MOE_ARCHS:
        cfg = jreg.smoke(arch)
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jinit(jax.random.PRNGKey(0), cfg))
        got = init_params(port_cfg(cfg), generator=torch.Generator().manual_seed(0),
                          device="cpu")
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
    p = L.init_moe(generator=torch.Generator().manual_seed(1), device="cpu", d_model=256,
                   d_ff=512, n_experts=8, shared_d_ff=64)
    assert abs(float(p["router"].std()) / 0.02 - 1) < 0.05
    assert abs(float(p["w_gate"].std()) * 16 - 1) < 0.05           # N(0, 1/d_model)
    assert abs(float(p["w_down"].std()) * np.sqrt(512) - 1) < 0.05  # N(0, 1/d_ff)
    assert set(p["shared"]) == {"w_gate", "w_up", "w_down"}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registry_matches_reference(arch):
    assert registry.get(arch) == port_cfg(jreg.get(arch))
    assert registry.smoke(arch) == port_cfg(jreg.smoke(arch))
    assert TransformerAdapter(registry.smoke(arch)).layer_kinds == \
        JAdapter(jreg.smoke(arch)).layer_kinds


# -- the model ---------------------------------------------------------------

def test_forward_matches_reference(pair):
    cfg, _, jp, _, tp, _ = pair
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 23))
    want, want_aux = jforward(jp, cfg, jnp.asarray(tok))
    got = forward(tp, port_cfg(cfg), torch.from_numpy(tok))
    close(got, want)
    # the reference's aux: the blocks' load-balance losses, summed
    x = tp["embed"][torch.from_numpy(tok)]
    pos = torch.arange(tok.shape[1])[None].repeat(tok.shape[0], 1)
    got_aux = 0.0
    for i in range(len(cfg.blocks)):
        x, aux, _ = block_forward(tp, port_cfg(cfg), i, x, pos)
        got_aux = got_aux + aux
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    head = tp["embed"].T if cfg.tie_embeddings else tp["lm_head"]
    assert torch.equal(L.rmsnorm(tp["final_norm"], x) @ head, got)


def test_adapter_blocks_match_reference(pair):
    cfg, ja, jp, ta, tp, _ = pair
    layer = cfg.blocks.index("moe_attn")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(13), (2, 1))
    for g, w in zip(ta.prefill_block(tp, layer, torch.from_numpy(x), torch.from_numpy(pos)),
                    ja.prefill_block(jp, layer, jnp.asarray(x), jnp.asarray(pos))):
        close(g, w)
    kv = rng.standard_normal((2, 2, 10, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    args = (x[:, :5], pos[:, :5] + 10, kv[0], kv[1])
    for g, w in zip(ta.prefill_block_with_ctx(tp, layer, *map(torch.from_numpy, args)),
                    ja.prefill_block_with_ctx(jp, layer, *map(jnp.asarray, args))):
        close(g, w)
    mask = rng.random((2, 10)) > 0.3
    step = (x[:, 0], np.array([10, 12], np.int32), kv[0], kv[1], mask)
    for g, w in zip(ta.decode_block(tp, layer, *map(torch.from_numpy, step)),
                    ja.decode_block(jp, layer, *map(jnp.asarray, step))):
        close(g, w)


def test_generate_matches_reference(pair):
    """Greedy ``generate``: equal tokens and per-layer ``(ids, mask)`` at
    every step (near-tie gaps checked), logits within 1e-4."""
    cfg, ja, jp, ta, tp, calib = pair
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 30))

    def run(engine, port):
        calls, logits = [], []
        record(engine, calls, port)
        step = engine.decode_step

        def logged_step(tok):
            out = step(tok)
            logits.append(np.asarray(out.numpy() if port else out))
            return out

        engine.decode_step = logged_step
        with engine:
            tokens = engine.generate(prompt, 10)
        return tokens, calls, logits

    want = run(JEngine(ja, jp, JConfig(**CFG), batch=2, calib_k=calib), False)
    got = run(KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib, device="cpu"),
              True)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == 10 * cfg.n_layers
    for (gi, gm), (wi, wm) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    for gl, wl in zip(got[2], want[2]):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=LOGIT_TOL)


def test_cold_and_warm_prefill_match_reference(pair):
    """Cold prefill, publish, then a warm ``prefill_cached`` of the same
    prompts (the suffix routed alone, with its own capacity) on both sides."""
    cfg, ja, jp, ta, tp, calib = pair
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache, \
            JCache(JCacheConfig(block_tokens=8)) as jcache:
        with KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib,
                          device="cpu") as e, \
                JEngine(ja, jp, JConfig(**CFG), batch=2, calib_k=calib) as je:
            close(e.prefill(prompt), je.prefill(prompt), rtol=0, atol=LOGIT_TOL)
            e.publish(cache)
            je.publish(jcache)
        with KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib,
                          device="cpu") as e, \
                JEngine(ja, jp, JConfig(**CFG), batch=2, calib_k=calib) as je:
            got, want = e.prefill_cached(prompt, cache), je.prefill_cached(prompt, jcache)
            assert e.prefill_report["cached_tokens"] == je.prefill_report["cached_tokens"] == 32
            close(got, want, rtol=0, atol=LOGIT_TOL)
            for t in (3, 7):
                close(e.decode_step(np.full(2, t)), je.decode_step(np.full(2, t)),
                      rtol=0, atol=LOGIT_TOL)


def test_session_matches_reference(pair):
    cfg, ja, jp, ta, tp, calib = pair
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, cfg.vocab_size, n) for n in (21, 34, 17, 26, 30)]

    def drive(sess):
        rids = [sess.submit(p, 6) for p in reqs]
        done = sess.drain()
        return [done[r].output.tolist() for r in rids]

    with JSession(ja, jp, JConfig(**CFG), slots=2, calib_k=calib) as js:
        want = drive(js)
    with ServeSession(ta, tp, EngineConfig(**CFG), slots=2, calib_k=calib, device="cpu") as ts:
        got = drive(ts)
    assert got == want


def test_warm_equals_cold_where_nothing_drops(pair):
    """The port's warm == cold bit-identity holds for MoE at a capacity
    factor of E/k (capacity = the call's length: no token can drop); at the
    config's own factor a short call may drop tokens, and then warm and
    cold prefill differ in the reference as in the port."""
    cfg, _, _, _, tp, calib = pair
    cfg = dataclasses.replace(port_cfg(cfg),
                              moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
    ta = TransformerAdapter(cfg)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache:
        with KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib,
                          device="cpu") as cold:
            lc = cold.prefill(prompt)
            cold.publish(cache)
            steps_c = [cold.decode_step(np.full(2, t)) for t in (5, 9)]
        with KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib,
                          device="cpu") as warm:
            lw = warm.prefill_cached(prompt, cache)
            assert warm.prefill_report["computed_tokens"] == 5
            steps_w = [warm.decode_step(np.full(2, t)) for t in (5, 9)]
    assert torch.equal(lc, lw)
    assert all(torch.equal(a, b) for a, b in zip(steps_c, steps_w))


# -- the CPU rehearsals of the chip run's new paths ----------------------------

def test_moe_path_on_cpu():
    """``chip_smoke.py``'s OLMoE path at a tiny size: the tuner's tuple into
    the engine, a session of 6 requests over 4 slots, a probe of one decode
    step's tensors, and the baselines scored on them."""
    cfg = registry.smoke("olmoe-1b-7b")
    tuned, ecfg = tuned_engine_config(cfg, b_max=4, s_max=256, budget_bytes=1 << 18,
                                      device_resident=True, async_io=True)
    assert (ecfg.group_size, ecfg.n_select, ecfg.rank) == \
        (tuned.group_size, tuned.n_select, tuned.rank)
    run = run_main_path(cfg, device="cpu", engine_cfg=ecfg, n_requests=6,
                        prompt_len=(64, 128), max_new=8, probe=(3, 1))
    assert all(o is not None and len(o) == 8 for o in run["outputs"])
    assert run["logits_finite"] and run["launches"] == {"lowrank_group_scores": 0,
                                                        "gather_attention": 0}
    probe = run["probe"]
    assert (probe["step"], probe["layer"]) == (3, 1) and list(probe["rows"]) == [0, 1, 2, 3]
    assert probe["q"].shape == (4, cfg.n_heads, cfg.head_dim)
    for bi in probe["rows"]:
        n = run["prompt_lens"][bi] + 3
        assert probe["k"][bi].shape == probe["v"][bi].shape == (n, cfg.n_kv_heads, cfg.head_dim)
        assert len(probe["k_disk"][bi]) == n // ecfg.group_size * ecfg.group_size
    fid = probe_fidelity(probe, group_size=ecfg.group_size, n_select=ecfg.n_select,
                         rank=ecfg.rank)
    assert list(fid["fidelity"]) == ["flexgen", "infinigen", "infinigen*", "shadowkv", "loki",
                                     "kvswap"]
    assert 0.0 <= fid["recall"] <= 1.0
    assert fid["fidelity"]["flexgen"]["recall"] == 1.0
    assert fid["fidelity"]["flexgen"]["out_err"] < 1e-6


def test_served_configs_on_cpu(capsys):
    """The StableLM and 2-layer dense paths' ``run_main_path`` calls at smoke
    widths, and the launcher with ``--engine disk`` on the new archs and with
    ``--engine device`` on OLMoE."""
    ecfg = EngineConfig(group_size=4, n_select=10, rank=16, reuse_capacity=16, max_seq=512,
                        device_resident=True, async_io=True)
    for arch in ("stablelm-12b", "granite-8b", "qwen3-32b", "chameleon-34b"):
        run = run_main_path(registry.smoke(arch), device="cpu", n_layers=2, engine_cfg=ecfg,
                            slots=2, n_requests=2, prompt_len=(64, 128), max_new=4)
        assert all(o is not None and len(o) == 4 for o in run["outputs"]) and \
            run["logits_finite"] and run["n_layers"] == 2
    for arch in ("olmoe-1b-7b", "stablelm-12b", "llama4-maverick-400b-a17b"):
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "24",
                          "--gen-len", "3"])
        assert out.shape == (2, 3)
    capsys.readouterr()
    out = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--engine", "device",
                      "--prompt-len", "24", "--gen-len", "3"])
    assert out.shape == (2, 3) and "device path (cpu)" in capsys.readouterr().out
