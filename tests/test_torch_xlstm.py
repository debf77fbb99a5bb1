"""The port's xLSTM (mLSTM and sLSTM blocks, ``configs/xlstm_1p3b.py``)
against the JAX package, on the reference's weights through the bridge.

Tolerances: the blocks' ``forward`` and ``step`` hold to 1e-5 (fp32 on both
sides; the recurrence runs the same operations in the same order, and a
dozen steps of it keep the rounding well inside that); the teacher-forced
model forward to 1e-4 relative and 1e-5 absolute (as
``test_torch_model.py``); prefill plus decode steps against the teacher-
forced forward to 2e-4, as ``tests/test_archs.py`` holds the reference.
Each test draws its inputs from its own numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as JS
from repro.models.transformer import (TransformerAdapter as JAdapter, forward as jforward,
                                      init_params as jinit)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry, xlstm_1p3b
from repro_torch.launch import serve
from repro_torch.models import ssm as S
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, forward
from repro_torch.serving import decode as D

TOL = 1e-5
D_MODEL, N_HEADS = 32, 4


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def smoke():
    """``(reference cfg, reference params, port cfg, port params)``: xLSTM smoke."""
    cfg = jreg.smoke("xlstm-1.3b")
    jp = jinit(jax.random.PRNGKey(3), cfg)
    return cfg, jp, port_cfg(cfg), params_from_numpy(tree_np(jp), "cpu")


def block_pair(kind: str):
    init = JS.init_mlstm if kind == "mlstm" else JS.init_slstm
    jp = init(jax.random.PRNGKey(1), d_model=D_MODEL, n_heads=N_HEADS)
    return jp, params_from_numpy(tree_np(jp), "cpu")


# -- the blocks -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_matches_reference(kind):
    jp, tp = block_pair(kind)
    x = np.random.default_rng(4).standard_normal((2, 13, D_MODEL)).astype(np.float32)
    jfwd = JS.mlstm_forward if kind == "mlstm" else JS.slstm_forward
    tfwd = S.mlstm_forward if kind == "mlstm" else S.slstm_forward
    want_y, want_st = jfwd(jp, jnp.asarray(x))
    got_y, got_st = tfwd(tp, torch.from_numpy(x))
    close(got_y, want_y)
    assert set(got_st) == set(want_st)
    for key in got_st:
        close(got_st[key], want_st[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_step_matches_reference(kind):
    """Steps from the initial state (stabiliser -inf) and from a carried one."""
    jp, tp = block_pair(kind)
    rng = np.random.default_rng(5)
    jstep = JS.mlstm_step if kind == "mlstm" else JS.slstm_step
    tstep = S.mlstm_step if kind == "mlstm" else S.slstm_step
    jinit_st = JS.mlstm_init_state if kind == "mlstm" else JS.slstm_init_state
    tinit_st = S.mlstm_init_state if kind == "mlstm" else S.slstm_init_state
    jst, tst = jinit_st(jp, 3), tinit_st(tp, 3)
    assert torch.isinf(tst["m"]).all() and (tst["m"] < 0).all()
    for _ in range(4):
        x = rng.standard_normal((3, D_MODEL)).astype(np.float32)
        want_y, jst = jstep(jp, jnp.asarray(x), jst)
        got_y, tst = tstep(tp, torch.from_numpy(x), tst)
        close(got_y, want_y)
        for key in tst:
            close(tst[key], jst[key])


def test_block_meta_and_init_layout():
    for kind in ("mlstm", "slstm"):
        jp, _ = block_pair(kind)
        init = S.init_mlstm if kind == "mlstm" else S.init_slstm
        tp = init(generator=torch.Generator().manual_seed(0), device="cpu", d_model=D_MODEL,
                  n_heads=N_HEADS)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == \
            jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        meta = (S.mlstm_meta if kind == "mlstm" else S.slstm_meta)(tp)
        assert meta == {"n_heads": N_HEADS, "head_dim": D_MODEL // N_HEADS}
    tp = S.init_mlstm(generator=torch.Generator().manual_seed(0), device="cpu",
                      d_model=D_MODEL, n_heads=N_HEADS)
    assert torch.equal(tp["b_if"], torch.tensor([0.0] * N_HEADS + [3.0] * N_HEADS))


# -- the model --------------------------------------------------------------------


def test_config_equals_reference():
    assert xlstm_1p3b.config() == port_cfg(jreg.get("xlstm-1.3b"))
    assert xlstm_1p3b.smoke_config() == port_cfg(jreg.smoke("xlstm-1.3b"))
    full = registry.get("xlstm-1.3b")
    assert (full.blocks.count("mlstm"), full.blocks.count("slstm")) == (42, 6)
    assert full.kv_layers == () and round(full.param_count() / 1e9, 2) == 1.03
    assert full.param_count() == jreg.get("xlstm-1.3b").param_count()
    assert TransformerAdapter(full).layer_kinds == ("state",) * 48


def test_init_params_layout_matches_reference(smoke):
    cfg, jp, tcfg, _ = smoke
    got = registry.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)


def test_forward_matches_reference(smoke):
    cfg, jp, tcfg, tp = smoke
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 15))
    want, want_aux = jforward(jp, cfg, jnp.asarray(toks))
    got, aux = forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert float(aux) == float(want_aux) == 0.0              # no MoE block


def test_adapter_state_blocks_match_reference(smoke):
    cfg, jp, tcfg, tp = smoke
    ja, ta = JAdapter(cfg), TransformerAdapter(tcfg)
    rng = np.random.default_rng(7)
    for layer in range(2):
        x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(9), (2, 1))
        gx, gst = ta.prefill_state_block(tp, layer, torch.from_numpy(x), torch.from_numpy(pos))
        wx, wst = ja.prefill_state_block(jp, layer, jnp.asarray(x), jnp.asarray(pos))
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-5)
        x1 = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        p1 = np.array([9, 9], np.int32)
        gy, gst = ta.decode_state_block(tp, layer, torch.from_numpy(x1), torch.from_numpy(p1), gst)
        wy, wst = ja.decode_state_block(jp, layer, jnp.asarray(x1), jnp.asarray(p1), wst)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-5)
        for key in gst:
            np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]), rtol=1e-4,
                                       atol=1e-5)
        init, ref = ta.init_state(tp, layer, 3), ja.init_state(jp, layer, 3)
        assert {k: tuple(t.shape) for k, t in init.items()} == \
            {k: a.shape for k, a in ref.items()}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_ssm_prefill_decode_consistency(arch):
    """``decode.prefill`` then single-token ``serve_step`` equals the
    teacher-forced forward (state handoff), as the reference's
    ``tests/test_archs.py`` holds it."""
    cfg = registry.smoke(arch)
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20)))
    cache = D.init_cache(cfg, 2, 32, device="cpu")
    logits, cache = D.prefill(params, cfg, toks[:, :16], cache)
    ref = forward(params, cfg, toks)[0]
    np.testing.assert_allclose(logits.numpy(), ref[:, 15].numpy(), rtol=0, atol=2e-4)
    for t in range(4):
        logits, cache = D.serve_step(params, cfg, toks[:, 16 + t:17 + t], cache)
        np.testing.assert_allclose(logits.numpy(), ref[:, 16 + t].numpy(), rtol=0, atol=2e-4)


def test_decode_matches_reference(smoke):
    """The port's ``decode.prefill``/``serve_step`` on xLSTM against the
    reference's, on its weights."""
    from repro.serving import decode as JD

    cfg, jp, tcfg, tp = smoke
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jc, tc = JD.init_cache(cfg, 2, 24), D.init_cache(tcfg, 2, 24, device="cpu")
    for ent_j, ent_t in zip(jc["layers"], tc["layers"]):
        np.testing.assert_array_equal(ent_t["m"].numpy(), np.asarray(ent_j["m"]))  # -1e30
    jl, jc = JD.prefill(jp, cfg, jnp.asarray(toks[:, :12]), jc)
    tl, tc = D.prefill(tp, tcfg, torch.from_numpy(toks[:, :12]), tc)
    close(tl, jl, 1e-4)
    for t in range(12, 16):
        jl, jc = JD.serve_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = D.serve_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tc)
        close(tl, jl, 1e-4)
    assert tc["length"] == int(jc["length"]) == 16


# -- the launcher ------------------------------------------------------------------


def test_engine_disk_refuses_a_model_without_kv(monkeypatch):
    """``--engine disk`` on xLSTM raises before any store is opened (the
    reference fails deeper, mapping an empty store file)."""
    from repro_torch.core import engine

    def no_engine(*a, **k):
        raise AssertionError("an engine (and its store) was built")

    monkeypatch.setattr(engine, "KVSwapEngine", no_engine)
    with pytest.raises(ValueError, match="no KV layer"):
        serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu", "--engine", "disk"])


def test_engine_device_serves_xlstm(capsys):
    out = serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu", "--engine", "device",
                      "--prompt-len", "24", "--gen-len", "4"])
    assert out.shape == (2, 4) and "device path (cpu)" in capsys.readouterr().out
