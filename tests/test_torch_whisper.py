"""The port's Whisper backbone (``models/whisper.py``, the layers it needs and
``configs/whisper_large_v3.py``) against the JAX package, on the
reference's weights through the bridge.

Tolerances: the layers (layer norm, the tanh-GELU MLP, bidirectional
attention) hold to 1e-6 (one layer of fp32 arithmetic in another order);
``encode``, ``decoder_forward`` and the adapter's blocks to 1e-4 (a stack of
them, as ``test_torch_model.py`` holds the decoder stack); through
``KVSwapEngine.generate`` the tokens, the per-layer selections and the I/O
accounting are equal and the logits within 1e-4, as
``test_torch_engine.py`` holds the dense model (the gap check there runs at
every step and layer; the seeds below keep every selection clear of
near-ties).  Each test draws its inputs from its own numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.models import layers as JL
from repro.models import whisper as JW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry, whisper_large_v3
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.launch import serve
from repro_torch.main_path import run_whisper_path, whisper_weights
from repro_torch.models import layers as TL
from repro_torch.models import whisper as W
from test_torch_engine import STAT_FIELDS
from test_torch_hybrid import run_engine

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128)
PROMPT_LEN = 30          # 7 full groups + a partial one of 2 tokens


def port_cfg(cfg) -> W.WhisperConfig:
    return W.WhisperConfig(**dataclasses.asdict(cfg))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    """``(reference cfg, reference params, port cfg, port params, frames,
    reference encoder output, port encoder output)``: Whisper smoke."""
    cfg = jreg.smoke("whisper-large-v3")
    jp = JW.init_params(jax.random.PRNGKey(2), cfg)
    tp = params_from_numpy(tree_np(jp), "cpu")
    frames = randn(1, 2, cfg.enc_frames, cfg.d_model)
    return (cfg, jp, port_cfg(cfg), tp, frames, JW.encode(jp, cfg, jnp.asarray(frames)),
            W.encode(tp, port_cfg(cfg), torch.from_numpy(frames)))


# -- the layers -----------------------------------------------------------------


def test_layernorm_matches_reference():
    x = randn(2, 3, 5, 48) * 3 + 1
    p = {"scale": 1 + 0.1 * randn(3, 48), "bias": 0.1 * randn(4, 48)}
    close(TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
          JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)), 1e-6)
    init = TL.init_layernorm(48, device="cpu")
    assert torch.equal(init["scale"], torch.ones(48)) and torch.equal(init["bias"], torch.zeros(48))


def test_gelu_mlp_matches_reference_tanh_approximation():
    jp = JL.init_gelu_mlp(jax.random.PRNGKey(5), 32, 96)
    jp = {**jp, "b_up": jnp.asarray(randn(6, 96)), "b_down": jnp.asarray(randn(7, 32))}
    tp = params_from_numpy(tree_np(jp), "cpu")
    x = randn(8, 4, 32) * 2
    got = TL.gelu_mlp(tp, torch.from_numpy(x))
    close(got, JL.gelu_mlp(jp, jnp.asarray(x)), 1e-6)
    # the erf GELU (torch's default) would be visibly off
    erf = F.gelu(torch.from_numpy(x) @ tp["w_up"] + tp["b_up"]) @ tp["w_down"] + tp["b_down"]
    assert float((erf - got).abs().max()) > 1e-5
    init = TL.init_gelu_mlp(generator=torch.Generator().manual_seed(0), device="cpu",
                            d_model=32, d_ff=96)
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_bidirectional_attention_matches_reference(masked):
    q, k, v = randn(9, 2, 7, 4, 16), randn(10, 2, 11, 2, 16), randn(11, 2, 11, 2, 16)
    mask = np.random.default_rng(12).random((2, 11)) > 0.3 if masked else None
    got = TL.bidirectional_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     None if mask is None else torch.from_numpy(mask))
    want = JL.bidirectional_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      None if mask is None else jnp.asarray(mask))
    close(got, want, 1e-6)


# -- config, params, model ------------------------------------------------------


def test_config_and_registry_equal_reference():
    assert whisper_large_v3.config() == port_cfg(jreg.get("whisper-large-v3"))
    assert whisper_large_v3.smoke_config() == port_cfg(jreg.smoke("whisper-large-v3"))
    full = registry.get("whisper-large-v3")
    assert registry.is_whisper(full) and full.enc_layers == 32
    model = registry.build_adapter(full)
    assert isinstance(model, W.WhisperAdapter) and model.layer_kinds == ("kv",) * 32
    assert not hasattr(model, "gather_context")       # the engine's host-gather route


def test_init_params_layout_matches_reference(smoke):
    cfg, jp, tcfg = smoke[:3]
    got = registry.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    again = W.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(got["dec_blocks"][1]["cross"]["wq"], again["dec_blocks"][1]["cross"]["wq"])


def test_sinusoid_positions_match_reference():
    """1e-6 at small positions; at position 1499 an angle's last bit alone
    is 2^-13 rad (one fp32 ulp at 1499), so there the two sides agree to
    2e-4."""
    for pos, tol in (([[0, 3, 11], [7, 2, 40]], 1e-6), ([[1499, 1024, 777]], 2e-4)):
        pos = np.array(pos, np.int32)
        close(W.sinusoid_positions(torch.from_numpy(pos), 128),
              JW.sinusoid_positions(jnp.asarray(pos), 128), tol)


def test_encode_and_cross_kv_match_reference(smoke):
    cfg, jp, tcfg, tp, _, jenc, tenc = smoke
    close(tenc, jenc, 1e-4)
    for (gk, gv), (wk, wv) in zip(W.cross_kv(tp, tcfg, tenc), JW.cross_kv(jp, cfg, jenc)):
        close(gk, wk, 1e-4)
        close(gv, wv, 1e-4)


def test_decoder_forward_matches_reference(smoke):
    cfg, jp, tcfg, tp, _, jenc, tenc = smoke
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 17))
    want, _ = JW.decoder_forward(jp, cfg, jnp.asarray(toks), jenc)
    close(W.decoder_forward(tp, tcfg, torch.from_numpy(toks), tenc), want, 1e-4)


def test_adapter_blocks_match_reference(smoke):
    cfg, jp, tcfg, tp, _, jenc, tenc = smoke
    ja, ta = JW.WhisperAdapter(cfg), W.WhisperAdapter(tcfg)
    with pytest.raises(RuntimeError, match="set_encoder_output"):
        ta.prefill_block(tp, 0, torch.zeros(2, 3, cfg.d_model), torch.zeros(2, 3, dtype=torch.int64))
    ja.set_encoder_output(jp, jenc)
    ta.set_encoder_output(tp, tenc)
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 9))
    pos = np.tile(np.arange(9), (2, 1))
    gx, wx = ta.embed(tp, torch.from_numpy(toks)), ja.embed(jp, jnp.asarray(toks))
    for layer in range(cfg.n_layers):
        gx, gk, gv = ta.prefill_block(tp, layer, gx, torch.from_numpy(pos))
        wx, wk, wv = ja.prefill_block(jp, layer, wx, jnp.asarray(pos))
        for g, w in ((gx, wx), (gk, wk), (gv, wv)):
            close(g, w, 1e-4)
    close(ta.logits(tp, gx), ja.logits(jp, wx), 1e-4)
    x1 = randn(15, 2, cfg.d_model)
    p1 = np.array([9, 9], np.int32)
    ctx_k, ctx_v = randn(16, 2, 12, cfg.n_kv_heads, cfg.head_dim), randn(17, 2, 12, 4, 32)
    mask = np.random.default_rng(18).random((2, 12)) > 0.3
    for layer in range(cfg.n_layers):
        got = ta.decode_block(tp, layer, torch.from_numpy(x1), torch.from_numpy(p1),
                              torch.from_numpy(ctx_k), torch.from_numpy(ctx_v),
                              torch.from_numpy(mask))
        want = ja.decode_block(jp, layer, jnp.asarray(x1), jnp.asarray(p1), jnp.asarray(ctx_k),
                               jnp.asarray(ctx_v), jnp.asarray(mask))
        for g, w in zip(got, want):
            close(g, w, 1e-4)
        close(ta.predict_query(tp, layer, torch.from_numpy(x1), torch.from_numpy(p1)),
              ja.predict_query(jp, layer, jnp.asarray(x1), jnp.asarray(p1)), 1e-4)


# -- through the engine -----------------------------------------------------------


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident-requested"])
def test_engine_matches_reference(smoke, resident):
    """``WhisperAdapter`` through ``KVSwapEngine.generate`` against the JAX
    engine: the adapter has no ``gather_context``, so both engines take the
    host-gather route whatever ``device_resident`` asks."""
    cfg, jp, tcfg, tp, _, jenc, tenc = smoke
    ja, ta = JW.WhisperAdapter(cfg), W.WhisperAdapter(tcfg)
    ja.set_encoder_output(jp, jenc)
    ta.set_encoder_output(tp, tenc)
    prompt = np.random.default_rng(19).integers(0, cfg.vocab_size, (2, PROMPT_LEN))
    calib = randn(20, 256, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(CFG, device_resident=resident)
    jeng = JEngine(ja, jp, JConfig(**kw), batch=2, calib_k=calib)
    teng = KVSwapEngine(ta, tp, EngineConfig(**kw), batch=2, calib_k=calib, device="cpu")
    assert not jeng.device_resident and not teng.device_resident
    want, got = run_engine(jeng, prompt, False), run_engine(teng, prompt, True)
    np.testing.assert_array_equal(got[0], want[0])                 # tokens
    assert len(got[1]) == len(want[1]) == 12 * cfg.n_layers
    for (gi, gm), (wi, wm) in zip(got[1], want[1]):                # per-layer selections
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    for gl, wl in zip(got[2], want[2]):                            # logits
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    assert got[3] == want[3]                                       # I/O accounting
    assert got[4] == want[4]                                       # modeled StepStats
    assert got[5] == want[5] and got[6] == cfg.n_layers
    assert set(STAT_FIELDS) <= set(got[4][0])


def test_whisper_path_on_cpu():
    """The chip smoke run's Whisper path, rehearsed at smoke size: the
    encoder once, then ``generate`` through the host-gather route; no kernel
    launch is counted on the CPU."""
    smoke = registry.smoke("whisper-large-v3")
    weights = whisper_weights(smoke, device="cpu", batch=2)
    cfg, _, enc_out, enc_s = weights
    assert enc_out.shape == (2, cfg.enc_frames, cfg.d_model) and enc_s > 0
    kw = dict(device="cpu", engine_cfg=EngineConfig(**CFG), prompt_len=PROMPT_LEN, max_new=6)
    run = run_whisper_path(cfg, weights=weights, **kw)
    assert run["tokens"].shape == (2, 6) and run["decode_steps"] == 6
    assert run["host_gather"] and run["logits_finite"] and run["prefill_seconds"] > 0
    assert run["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0}
    # the same weights, built by the path itself from the same seed
    np.testing.assert_array_equal(run_whisper_path(smoke, batch=2, **kw)["tokens"], run["tokens"])
    cut = whisper_weights(smoke, device="cpu", n_layers=1, batch=1)
    assert cut[0].n_layers == cut[0].enc_layers == 1 and len(cut[1]["enc_blocks"]) == 1
    assert run_whisper_path(smoke, n_layers=1, batch=1, **kw)["n_layers"] == 1


@pytest.mark.parametrize("engine", ["disk", "device"])
def test_launcher(engine, capsys):
    out = serve.main(["--arch", "whisper-large-v3", "--smoke", "--device", "cpu", "--engine",
                      engine, "--prompt-len", "24", "--gen-len", "4"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert ("modeled nvme throughput" if engine == "disk" else "device path (cpu)") in text
