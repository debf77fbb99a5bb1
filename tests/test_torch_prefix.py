"""The port's prefix cache (``repro_torch.cache``) and warm prefill against
the JAX package, and the port's own warm == cold bit-identity.

Port against reference, on the reference's weights through the bridge: the
same tokens give the same block ids and the same manifest geometry and
extents; chunked attention and the chunked block match within the
tolerance of ``test_torch_model.py``; warm-prefill logits match the
reference's within 1e-4 (the tolerance ``test_torch_engine.py`` states);
a serving session with the cache gives the reference session's tokens.

Inside the port: warm prefill (restored prefix KV plus the chunked suffix)
is bit-identical to cold prefill of the same prompt, through
``prefill_cached`` and through ``admit_row(cache=...)``, for the logits and
the decode steps after, with the prefix published by a prefill of that
prompt and a suffix of two tokens or more (the contract of
``KVSwapEngine.prefill_cached`` on the CPU: a one-token suffix takes the
matrix-vector route, whose bits differ).  The reference's own warm == cold checks fail on
this JAX (``ROADMAP.md`` §3), so the tolerance holds the port to the
reference and bit-identity holds the port to itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.cache import chain_blocks as jchain
from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.models import layers as JL
from repro.serving.api import ServeSession as JSession
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig, chain_blocks
from repro_torch.core.engine import EngineConfig, KVSwapEngine, PublishResult
from repro_torch.faults.errors import MediaError, StorageFault
from repro_torch.main_path import run_prefix_path
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.serving import ServeSession

CFG = dict(group_size=4, n_select=8, rank=8, reuse_capacity=16, max_seq=128)
TOL = 1e-4


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    """``(reference adapter, reference params, port adapter, port params,
    calibration K)`` on the reference's weights."""
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(3).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib)


def engine(parts, batch=2, **kw):
    return KVSwapEngine(parts[2], parts[3], EngineConfig(**{**CFG, **kw}), batch=batch,
                        calib_k=parts[4], device="cpu")


def ref_engine(parts, batch=2):
    return JEngine(parts[0], parts[1], JConfig(**CFG), batch=batch, calib_k=parts[4])


def prompts(seed, shape):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(np.int32)


def published(parts, prompt, cfg=PrefixCacheConfig(block_tokens=8)) -> PrefixCache:
    cache = PrefixCache(cfg)
    with engine(parts, batch=prompt.shape[0]) as e:
        e.prefill(prompt)
        e.publish(cache)
    return cache


# -- port against reference ---------------------------------------------------

def test_block_ids_and_manifest_match_reference(parts):
    prompt = prompts(1, (2, 37))
    for toks in (prompt[0], prompt[0].astype(np.int64)):
        assert ([b.block_id for b in chain_blocks(toks, 8)]
                == [b.block_id for b in jchain(toks, 8)])
    with published(parts, prompt) as cache, JCache(JCacheConfig(block_tokens=8)) as jcache:
        with ref_engine(parts) as je:
            je.prefill(prompt)
            je.publish(jcache)
        assert (dataclasses.asdict(cache.manifest.geometry)
                == dataclasses.asdict(jcache.manifest.geometry))
        layout = lambda c: {bid: (m.parent_id, m.index, m.n_tokens, m.start_group, m.n_groups)
                            for bid, m in c.manifest.blocks.items()}
        assert layout(cache) == layout(jcache)
        assert cache.resident_blocks() == 8


def test_chunked_attention_matches_reference_and_causal():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 4, 16), (2, 13, 2, 16), (2, 13, 2, 16)))
    got = L.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), 8)
    want = JL.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-5)
    full = [torch.from_numpy(t[:, :5]) for t in (k, k, v)]
    full[0] = torch.from_numpy(q)
    assert torch.equal(L.chunked_causal_attention(*full, 0), L.causal_attention(*full))


def test_prefill_block_with_ctx_matches_reference(parts):
    jm, jp, model, params, _ = parts
    x = np.random.default_rng(5).standard_normal((1, 6, 64)).astype(np.float32)
    kp = np.random.default_rng(6).standard_normal((1, 10, 2, 16)).astype(np.float32)
    vp = np.random.default_rng(7).standard_normal((1, 10, 2, 16)).astype(np.float32)
    pos = np.arange(10, 16)[None]
    got = model.prefill_block_with_ctx(params, 1, *map(torch.from_numpy, (x, pos, kp, vp)))
    want = jm.prefill_block_with_ctx(jp, 1, *map(jnp.asarray, (x, pos, kp, vp)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=1e-5)


def test_warm_prefill_matches_reference(parts):
    prompt = prompts(8, (2, 37))
    with published(parts, prompt) as cache, engine(parts) as e:
        got = e.prefill_cached(prompt, cache).numpy()
        assert e.prefill_report["cached_tokens"] == 32
    with JCache(JCacheConfig(block_tokens=8)) as jcache:
        with ref_engine(parts) as je:
            je.prefill(prompt)
            je.publish(jcache)
        with ref_engine(parts) as je:
            want = np.asarray(je.prefill_cached(prompt, jcache))
            assert je.prefill_report["cached_tokens"] == 32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_session_with_cache_matches_reference(parts):
    """Publish-at-retirement and warm admissions in a session: the same
    tokens, cached tokens and published blocks as the reference session."""
    rng = np.random.default_rng(9)
    head = rng.integers(0, 97, 24)
    reqs = [np.concatenate([head, rng.integers(0, 97, n)]) for n in (9, 13, 6, 11)]

    def drive(sess):
        rids = [sess.submit(p, 5) for p in reqs]
        done = sess.drain()
        return ([done[r].output.tolist() for r in rids],
                [done[r].cached_tokens for r in rids], sess.published_blocks)

    with JCache(JCacheConfig(block_tokens=8)) as jcache, \
            JSession(parts[0], parts[1], JConfig(**CFG), slots=2, calib_k=parts[4],
                     prefix_cache=jcache) as js:
        want = drive(js)
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache, \
            ServeSession(parts[2], parts[3], EngineConfig(**CFG), slots=2, calib_k=parts[4],
                         prefix_cache=cache, device="cpu") as ts:
        got = drive(ts)
        assert ts.stats()["publish_failures"] == 0 and ts.stats()["save_failures"] == 0
    assert got == want
    assert got[1][2:] == [24, 24]        # the later admissions restored the head


# -- the port's own warm == cold contract ------------------------------------

def test_warm_prefill_cached_bit_identical(parts):
    """Warm ``prefill_cached`` and the decode steps after it equal the
    cold prefill's bit for bit."""
    prompt = prompts(10, (2, 37))
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache:
        with engine(parts) as cold:
            lc = cold.prefill(prompt)
            assert isinstance(cold.publish(cache), PublishResult)
            cold_steps = [cold.decode_step(np.full(2, t)) for t in (5, 9, 13)]
        with engine(parts) as warm:
            lw = warm.prefill_cached(prompt, cache)
            assert warm.prefill_report["cached_tokens"] == 32
            assert warm.prefill_report["computed_tokens"] == 5
            warm_steps = [warm.decode_step(np.full(2, t)) for t in (5, 9, 13)]
    assert torch.equal(lc, lw)
    for a, b in zip(cold_steps, warm_steps):
        assert torch.equal(a, b)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host"])
def test_warm_admit_row_bit_identical(parts, resident):
    """``admit_row(cache=...)`` into a slot while another slot is mid-decode
    (the device tail of the admitted row is seeded from the host): the
    admission's logits and every later step equal a cold admission's."""
    other, prompt = prompts(11, 23), prompts(12, 45)

    def run(cache):
        with engine(parts, device_resident=resident) as e:
            e.admit_row(0, other)
            e.decode_step(np.array([3, 0]))
            logits = [e.admit_row(1, prompt, cache)]
            n_cached = e.prefill_report["cached_tokens"]
            logits += [e.decode_step(np.array([t, t + 1])) for t in (4, 8, 15)]
            return logits, n_cached

    with published(parts, prompt[None]) as cache:
        warm, n_cached = run(cache)
    cold, _ = run(None)
    assert n_cached == 40
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)


def test_fully_cached_prompt_still_recomputes_tail(parts):
    prompt = prompts(13, (2, 32))
    with published(parts, prompt) as cache, engine(parts) as warm:
        lw = warm.prefill_cached(prompt, cache)
        assert warm.prefill_report["cached_tokens"] == 24
        with engine(parts) as cold:
            assert torch.equal(cold.prefill(prompt), lw)


def test_unrelated_prompt_falls_back_cold(parts):
    p2 = prompts(15, (2, 24))
    with published(parts, prompts(14, (2, 24))) as cache, engine(parts) as e2:
        lw = e2.prefill_cached(p2, cache)
        assert e2.prefill_report["cached_tokens"] == 0
        with engine(parts) as e3:
            assert torch.equal(e3.prefill(p2), lw)


def test_publish_dedups_across_engines(parts):
    prompt = prompts(16, (2, 24))
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache:
        with engine(parts) as e1:
            e1.prefill(prompt)
            n1 = e1.publish(cache)
            again = e1.publish(cache)
            assert again == 0 and again.heads == n1.heads
        with engine(parts) as e2:
            e2.prefill(prompt)
            assert e2.publish(cache) == 0
        assert n1 == cache.resident_blocks() == 6
        assert n1.heads[0] == chain_blocks(prompt[0], 8)[-1].block_id


def test_restore_reads_are_sequential_runs(parts):
    """One coalesced restore read per (layer, row chain), charged to the
    engine's accountant."""
    prompt = prompts(17, (2, 32))
    with published(parts, prompt) as cache, engine(parts) as e2:
        e2.accountant.reset()
        e2.prefill_cached(prompt, cache)
        assert e2.prefill_report["cached_tokens"] == 24
        assert e2.prefill_report["restore_seconds"] > 0
        assert e2.accountant.snapshot()["read_requests"] == 4   # 2 layers x 2 chains


def test_failed_restore_unpins_on_every_path(parts):
    prompt = prompts(18, (2, 37))
    with published(parts, prompt) as cache, engine(parts) as e2:
        orig = cache.store.read_extents

        def boom(*a, **kw):
            raise MediaError("injected: extent unreadable")

        cache.store.read_extents = boom
        try:
            with pytest.raises(StorageFault):
                e2.admit_row(0, prompt[0], cache)
        finally:
            cache.store.read_extents = orig
        assert all(m.pins == 0 for m in cache.manifest.blocks.values())
        assert not e2.row_active[0] and e2.row_seq[0] == 0
        e2.admit_row(0, prompt[0], cache)
        assert e2.prefill_report["cached_tokens"] > 0
        e2.retire_row(0)
        assert all(m.pins == 0 for m in cache.manifest.blocks.values())


def test_hybrid_falls_back_cold():
    cfg = ModelConfig(name="hyb", arch_type="hybrid", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=61,
                      block_pattern=("mamba2", "shared_attn"), ssm_state=16)
    params = init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    calib = np.random.default_rng(19).standard_normal((128, 4, 16))
    ecfg = EngineConfig(group_size=4, n_select=8, rank=8, reuse_capacity=8, max_seq=64)
    prompt = np.random.default_rng(20).integers(0, 61, (2, 17))
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache, \
            KVSwapEngine(TransformerAdapter(cfg), params, ecfg, batch=2, calib_k=calib,
                         device="cpu") as eng:
        assert eng.prefill_cached(prompt, cache).shape == (2, 61)
        assert eng.prefill_report["cached_tokens"] == 0
        assert eng.publish(cache) == 0


def test_prefix_path_on_cpu(tiny_cfg):
    """The chip smoke run's prefix path, rehearsed at 2 layers."""
    run = run_prefix_path(ModelConfig(**dataclasses.asdict(tiny_cfg)), device="cpu",
                          engine_cfg=EngineConfig(**{**CFG, "max_seq": 256}, async_io=True),
                          slots=2, n_requests=4, prefix_len=64, suffix_len=(8, 24),
                          max_new=6, cache_cfg=PrefixCacheConfig(block_tokens=8))
    assert run["n_layers"] == 2
    assert [a["cached_tokens"] for a in run["admissions"]] == [0, 0, 64, 64]
    assert all(a["restore_bytes"] > 0 for a in run["admissions"][2:])
    assert run["publish_write_bytes"] > 0 and run["resident_blocks"] > 8
    assert [len(o) for o in run["outputs"]] == [6] * 4 and run["logits_finite"]
    assert all(run["tokens_equal"])
    # the CPU runs the plain versions: no kernel launch is counted
    assert run["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0}
    wc = run["warm_cold"]
    assert wc["cached_tokens"] == 64 and wc["bits_equal"] and wc["first_divergence"] is None
    assert run["warm_profile"]["restore_bytes"] > 0
