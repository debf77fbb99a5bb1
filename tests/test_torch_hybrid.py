"""The port's Zamba2-style hybrid (Mamba2 blocks with shared-weight
attention) against the JAX package, and its own bit-identity checks.

Port against reference, on the reference's weights through the bridge:
the config and registry, the ``init_params`` layout, the adapter's state
and shared-attention methods, the teacher-forced ``forward``, and
``KVSwapEngine.generate`` on the 3-block hybrid of ``tests/test_engine.py``
and on Zamba2 smoke — equal tokens, equal per-layer ``(ids, mask)``, equal
``IOAccountant.snapshot()``, equal modeled ``StepStats``, equal
``metadata_bytes()``, and logits within 1e-4 (the tolerance
``test_torch_engine.py`` states: fp32 on both sides, XLA's fused blocks
and PyTorch's eager ones round differently by a few ulps per layer).
Selections are exact only away from near-ties, so the gap check of
``test_torch_engine.py`` runs at every step and layer; the seeds below were
chosen so that no step comes closer than 1e-4 of the row's score scale.

Adapter and forward comparisons hold to 1e-4 relative and 1e-5 absolute
(as ``test_torch_model.py``); the port's prefill-then-step logits against
its own teacher-forced forward hold to 2e-4 (as ``tests/test_archs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.models.transformer import (ModelConfig as JModelConfig, TransformerAdapter as JAdapter,
                                      forward as jforward, init_params as jinit)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry, zamba2_1p2b
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.launch import serve
from repro_torch.main_path import run_hybrid_path
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, forward, init_params
from repro_torch.serving import ServeSession
from test_torch_engine import STAT_FIELDS, record

RTOL, ATOL = 1e-4, 1e-5
HYB3 = JModelConfig(name="hyb", arch_type="hybrid", n_layers=3, d_model=64, n_heads=4,
                    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=61,
                    block_pattern=("mamba2", "shared_attn", "mamba2"), ssm_state=16)
CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128)
STEPS = 12
PROMPT_LEN = 30          # 7 full groups + a partial one of 2 tokens


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def calib_k(cfg, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (256, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)


MODELS = {"hyb3": lambda: HYB3, "zamba2-smoke": lambda: jreg.smoke("zamba2-1.2b")}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """``(name, reference cfg, reference adapter, reference params, port
    adapter, port params)`` on the reference's weights."""
    cfg = MODELS[request.param]()
    jp = jinit(jax.random.PRNGKey(1), cfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return request.param, cfg, JAdapter(cfg), jp, TransformerAdapter(port_cfg(cfg)), tp


def close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# -- config, registry, params --------------------------------------------------


def test_configs_and_registry_equal_reference():
    assert zamba2_1p2b.config() == port_cfg(jreg.get("zamba2-1.2b"))
    assert zamba2_1p2b.smoke_config() == port_cfg(jreg.smoke("zamba2-1.2b"))
    assert registry.ARCHS == jreg.ARCHS and registry.ALL_ARCHS == jreg.ALL_ARCHS
    for arch in ("llama3-8b", "qwen3-8b", "zamba2-1.2b"):
        assert registry.get(arch) == port_cfg(jreg.get(arch))
        assert registry.smoke(arch) == port_cfg(jreg.smoke(arch))
    full = zamba2_1p2b.config()
    assert (full.blocks.count("mamba2"), full.blocks.count("shared_attn")) == (32, 6)
    assert TransformerAdapter(full).layer_kinds.count("kv") == 6


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-large-v3"])
def test_registry_refuses_what_the_port_lacks(arch):
    """The last two archs the port lacked are in: the registry returns the
    reference's configs and their adapters build; only an unknown arch is
    refused."""
    from repro_torch.models.whisper import WhisperConfig
    conv = WhisperConfig if jreg.is_whisper(jreg.get(arch)) else ModelConfig
    for get, jget in ((registry.get, jreg.get), (registry.smoke, jreg.smoke)):
        cfg = get(arch)
        assert cfg == conv(**dataclasses.asdict(jget(arch)))
        assert registry.is_whisper(cfg) == jreg.is_whisper(jget(arch))
        model = registry.build_adapter(cfg)
        assert model.layer_kinds == jreg.build_adapter(jget(arch)).layer_kinds
    with pytest.raises(KeyError):
        registry.get("no-such-arch")


def test_init_params_layout_matches_reference():
    cfg = jreg.smoke("zamba2-1.2b")
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jinit(jax.random.PRNGKey(0), cfg))
    got = registry.init_params(port_cfg(cfg), generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
    again = init_params(port_cfg(cfg), generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(got["blocks"][0]["mamba"]["in_proj"], again["blocks"][0]["mamba"]["in_proj"])
    assert set(got["blocks"][1]) == {"attn_norm"}          # shared weights live apart
    assert set(got["shared_attn"]) == {"attn", "mlp_norm", "mlp"}


# -- adapter and forward ------------------------------------------------------


class TestAdapter:
    def test_layer_kinds(self, pair):
        _, cfg, ja, _, ta, _ = pair
        assert ta.layer_kinds == ja.layer_kinds
        assert ta.layer_kinds == tuple("kv" if k == "shared_attn" else "state"
                                       for k in cfg.blocks)

    def test_state_blocks(self, pair):
        _, cfg, ja, jp, ta, tp = pair
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(11), (2, 1))
        got_x, got_st = ta.prefill_state_block(tp, 0, torch.from_numpy(x), torch.from_numpy(pos))
        want_x, want_st = ja.prefill_state_block(jp, 0, jnp.asarray(x), jnp.asarray(pos))
        close(got_x, want_x)
        for key in ("conv", "ssm"):
            close(got_st[key], want_st[key])
        x1 = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        p1 = np.array([11, 11], np.int32)
        got = ta.decode_state_block(tp, 0, torch.from_numpy(x1), torch.from_numpy(p1), got_st)
        want = ja.decode_state_block(jp, 0, jnp.asarray(x1), jnp.asarray(p1), want_st)
        close(got[0], want[0])
        for key in ("conv", "ssm"):
            close(got[1][key], want[1][key])
        init = ta.init_state(tp, 0, 3)
        ref = ja.init_state(jp, 0, 3)
        for key in ("conv", "ssm"):
            assert tuple(init[key].shape) == ref[key].shape and not init[key].any()
        with pytest.raises(ValueError):
            ta.init_state(tp, 1, 3)

    def test_shared_attention_blocks(self, pair):
        _, cfg, ja, jp, ta, tp = pair
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(9), (2, 1))
        got = ta.prefill_block(tp, 1, torch.from_numpy(x), torch.from_numpy(pos))
        want = ja.prefill_block(jp, 1, jnp.asarray(x), jnp.asarray(pos))
        for g, w in zip(got, want):
            close(g, w)
        b, n = 3, 20
        x1 = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        p1 = np.array([20, 27, 33], np.int32)
        k = rng.standard_normal((b, n, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        v = rng.standard_normal((b, n, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        mask = rng.random((b, n)) > 0.4
        got = ta.decode_block(tp, 1, *(torch.from_numpy(a) for a in (x1, p1, k, v, mask)))
        want = ja.decode_block(jp, 1, *(jnp.asarray(a) for a in (x1, p1, k, v, mask)))
        for g, w in zip(got, want):
            close(g, w)
        close(ta.predict_query(tp, 1, torch.from_numpy(x1), torch.from_numpy(p1)),
              ja.predict_query(jp, 1, jnp.asarray(x1), jnp.asarray(p1)))

    def test_forward_matches_reference(self, pair):
        _, cfg, _, jp, _, tp = pair
        tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 21))
        want, _ = jforward(jp, cfg, jnp.asarray(tok))
        close(forward(tp, port_cfg(cfg), torch.from_numpy(tok)), want)

    def test_prefill_then_steps_match_teacher_forced_forward(self, pair):
        """Chunked prefill of 16 tokens, then 4 single steps over the full
        KV, equal the teacher-forced forward (the port's counterpart of
        ``tests/test_archs.py::test_ssm_prefill_decode_consistency``)."""
        _, cfg, _, _, ta, tp = pair
        tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20)))
        want = forward(tp, port_cfg(cfg), tok)
        x = ta.embed(tp, tok[:, :16])
        pos = torch.arange(16)[None].repeat(2, 1)
        states, kv = {}, {}
        for layer, kind in enumerate(ta.layer_kinds):
            if kind == "state":
                x, states[layer] = ta.prefill_state_block(tp, layer, x, pos)
            else:
                x, k, v = ta.prefill_block(tp, layer, x, pos)
                kv[layer] = [k, v]
        close(ta.logits(tp, x[:, -1]), want[:, 15].numpy(), rtol=0, atol=2e-4)
        for t in range(16, 20):
            x = ta.embed(tp, tok[:, t])
            p1 = torch.full((2,), t)
            for layer, kind in enumerate(ta.layer_kinds):
                if kind == "state":
                    x, states[layer] = ta.decode_state_block(tp, layer, x, p1, states[layer])
                else:
                    k, v = kv[layer]
                    x, kn, vn = ta.decode_block(tp, layer, x, p1, k, v,
                                                torch.ones(k.shape[:2], dtype=torch.bool))
                    kv[layer] = [torch.cat([k, kn[:, None]], 1), torch.cat([v, vn[:, None]], 1)]
            close(ta.logits(tp, x), want[:, t].numpy(), rtol=0, atol=2e-4)


# -- the engine against the JAX engine ---------------------------------------


def run_engine(engine, prompt, port: bool):
    calls, logits = [], []
    record(engine, calls, port)
    step = engine.decode_step

    def logged_step(tok):
        out = step(tok)
        logits.append(np.asarray(out.numpy() if port else out))
        return out

    engine.decode_step = logged_step
    tokens = engine.generate(prompt, STEPS)
    snap = engine.accountant.snapshot()
    stats = [{f: getattr(s, f) for f in STAT_FIELDS} for s in engine.step_log]
    meta = engine.metadata_bytes()
    n_store_layers = engine.store.n_layers
    engine.close()
    return tokens, calls, logits, snap, stats, meta, n_store_layers


PROMPT_SEEDS = {"hyb3": 5, "zamba2-smoke": 5}


def test_engine_matches_reference(pair):
    name, cfg, ja, jp, ta, tp = pair
    prompt = np.random.default_rng(PROMPT_SEEDS[name]).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN))
    calib = calib_k(cfg)
    want = run_engine(JEngine(ja, jp, JConfig(**CFG), batch=2, calib_k=calib), prompt, False)
    got = run_engine(KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib,
                                  device="cpu"), prompt, True)
    np.testing.assert_array_equal(got[0], want[0])                 # tokens
    n_kv = len(cfg.kv_layers)
    assert len(got[1]) == len(want[1]) == STEPS * n_kv
    for (gi, gm), (wi, wm) in zip(got[1], want[1]):                # per-layer selections
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    for gl, wl in zip(got[2], want[2]):                            # logits
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    assert got[3] == want[3]                                       # I/O accounting
    assert got[4] == want[4]                                       # modeled StepStats
    assert got[5] == want[5]                                       # metadata_bytes
    assert got[6] == n_kv                                          # only KV layers on disk


def full_kv_generate(tp, cfg, prompt, n_new):
    """Greedy decode with the port's teacher-forced full forward (oracle)."""
    toks = torch.from_numpy(np.asarray(prompt))
    out = []
    for _ in range(n_new):
        nxt = forward(tp, cfg, toks)[:, -1].argmax(-1)
        out.append(nxt.numpy())
        toks = torch.cat([toks, nxt[:, None]], 1)
    return np.stack(out, 1)


def test_full_coverage_matches_full_kv():
    """Full-rank adapter and M covering every group: the sparse engine is
    exact, so it equals the full-KV greedy oracle token for token (the
    port's counterpart of ``tests/test_engine.py::TestHybrid``)."""
    cfg = port_cfg(HYB3)
    tp = init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    ta = TransformerAdapter(cfg)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    ecfg = EngineConfig(group_size=4, n_select=32, rank=cfg.n_kv_heads * cfg.head_dim,
                        reuse_capacity=32, max_seq=64, predict_from="self")
    with KVSwapEngine(ta, tp, ecfg, batch=2, calib_k=calib_k(cfg, 0), device="cpu") as eng:
        got = eng.generate(prompt, 6)
        assert eng.store.n_layers == 1
        assert sorted(eng.states) == [0, 2]
    np.testing.assert_array_equal(got, full_kv_generate(tp, cfg, prompt, 6))


_REFS: dict = {}


@pytest.mark.parametrize("dr", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("aio", [False, True], ids=["sync", "async"])
def test_bit_identity_async_and_resident(dr, aio):
    cfg = zamba2_1p2b.smoke_config()
    tp = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 27))

    def gen(**kw):
        with KVSwapEngine(TransformerAdapter(cfg), tp, EngineConfig(**{**CFG, **kw}), batch=2,
                          calib_k=calib_k(cfg), device="cpu") as eng:
            return eng.generate(prompt, 8)

    if "ref" not in _REFS:
        _REFS["ref"] = gen(device_resident=False, async_io=False)
    np.testing.assert_array_equal(gen(device_resident=dr, async_io=aio), _REFS["ref"])


def test_session_and_admit_row_refuse_a_hybrid():
    cfg = zamba2_1p2b.smoke_config()
    tp = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ta = TransformerAdapter(cfg)
    with pytest.raises(ValueError, match="attention-only"):
        ServeSession(ta, tp, EngineConfig(**CFG), slots=2, calib_k=calib_k(cfg), device="cpu")
    with KVSwapEngine(ta, tp, EngineConfig(**CFG), batch=2, calib_k=calib_k(cfg),
                      device="cpu") as eng:
        with pytest.raises(ValueError, match="attention-only"):
            eng.admit_row(0, np.zeros(8, np.int64))


def test_serve_launcher(capsys):
    out = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                      "--prompt-len", "24", "--gen-len", "4"])
    assert out.shape == (2, 4)
    assert "modeled nvme throughput" in capsys.readouterr().out
    out = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--engine", "device",
                      "--prompt-len", "24", "--gen-len", "4"])
    assert out.shape == (2, 4)
    assert "device path (cpu)" in capsys.readouterr().out


def test_hybrid_path_on_cpu():
    """The chip smoke run's hybrid path, rehearsed at a tiny size: four
    blocks of Zamba2 smoke widths, async and sync I/O."""
    cfg = dataclasses.replace(zamba2_1p2b.smoke_config(), n_layers=4,
                              block_pattern=("mamba2", "shared_attn") * 2)
    runs = {aio: run_hybrid_path(cfg, device="cpu", batch=2, prompt_len=37, max_new=6,
                                 engine_cfg=EngineConfig(**CFG, async_io=aio))
            for aio in (True, False)}
    run = runs[True]
    assert run["tokens"].shape == (2, 6)
    assert (run["n_layers"], run["n_kv_layers"], run["n_store_layers"], run["n_states"]) == \
        (4, 2, 2, 2)
    assert run["decode_steps"] == 6 and len(run["decode_step_wall_seconds"]) == 6
    assert run["logits_finite"] and run["prefill_seconds"] > 0
    # the CPU runs the plain versions: no kernel launch is counted
    assert run["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0, "ssd_chunk": 0}
    np.testing.assert_array_equal(runs[True]["tokens"], runs[False]["tokens"])


def test_hybrid_prefill_profile_on_cpu():
    """The chip smoke run's profiled second prefill, rehearsed at a tiny
    size: it runs after ``generate`` and its launch counts are read, so the
    tokens, counts and first prefill are those of a run without it; on the
    CPU the trace holds no device time, so the whole window is host work."""
    cfg = dataclasses.replace(zamba2_1p2b.smoke_config(), n_layers=4,
                              block_pattern=("mamba2", "shared_attn") * 2)
    kw = dict(device="cpu", batch=2, prompt_len=37, max_new=4, engine_cfg=EngineConfig(**CFG))
    plain = run_hybrid_path(cfg, **kw)
    run = run_hybrid_path(cfg, profile_prefill=True, **kw)
    assert plain["prefill_profile"] is None
    np.testing.assert_array_equal(run["tokens"], plain["tokens"])
    assert run["launches"] == plain["launches"] and run["logits_finite"]
    prof = run["prefill_profile"]
    assert prof["window_ms"] > 0 and prof["device_busy_ms"] == 0 and prof["ops"] == []
    assert prof["host_only_ms"] == prof["window_ms"] and prof["device_busy_share"] == 0
