"""The port's full-cache serve path (``repro_torch.serving.decode``) against
the JAX package's ``repro.serving.decode``: the counterparts of
``tests/test_serving.py`` on the same arches plus OLMoE, and the in-place
cache contract that replaces the reference's functional one.

Tolerances: the port's prefill and decode steps against its own
teacher-forced forward hold to 5e-4, as the reference's test holds the
reference; the port against the reference on the reference's weights to
1e-4 (fp32 on both sides, ops in another order); ``kvswap`` selecting every
group against ``full`` to 5e-4 after the prefill's 1e-5, the rolling buffer
against the direct path to 2e-4, as the reference holds itself.  The
``kvswap`` selections (the top-M group ids at every layer and step) equal
the reference's exactly.  Each test draws its inputs from its own numpy
seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import whisper as JW
from repro.serving import decode as JD
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.main_path import run_device_path
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.serving import decode as D

ARCHS_EQUIV = ["llama3-8b", "qwen3-32b", "zamba2-1.2b", "xlstm-1.3b", "whisper-large-v3",
               "granite-8b", "olmoe-1b-7b"]


def nodrop(cfg):
    if not jreg.is_whisper(cfg) and cfg.n_experts:
        return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts) / cfg.moe_top_k)
    return cfg


def port_cfg(cfg):
    return (W.WhisperConfig if jreg.is_whisper(cfg) else T.ModelConfig)(**dataclasses.asdict(cfg))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(arch, seed=0, rank=None):
    """``(reference cfg, reference params, port cfg, port params)`` on the
    reference's weights; ``rank`` attaches the reference's adapters."""
    cfg = nodrop(jreg.smoke(arch))
    jp = jreg.init_params(jax.random.PRNGKey(seed), cfg)
    if rank:
        jp = JD.attach_kvswap_adapters(jax.random.PRNGKey(seed + 1), jp, cfg, rank)
    return cfg, jp, port_cfg(cfg), params_from_numpy(tree_np(jp), "cpu")


def encoder_out(cfg, jp, tcfg, tp, b):
    if not jreg.is_whisper(cfg):
        return None, None
    frames = np.random.default_rng(1).standard_normal((b, cfg.enc_frames, cfg.d_model))
    frames = frames.astype(np.float32)
    return (JW.encode(jp, cfg, jnp.asarray(frames)),
            W.encode(tp, tcfg, torch.from_numpy(frames)))


def scfgs(**kw):
    return JD.KVSwapServeConfig(**kw), D.KVSwapServeConfig(**kw)


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ARCHS_EQUIV)
def test_serve_step_matches_teacher_forcing(arch):
    """The port's prefill and steps equal its teacher-forced forward (as the
    reference's do its own), and the reference's prefill and steps."""
    cfg, jp, tcfg, tp = pair(arch)
    b, s = 2, 12
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s + 4)).astype(np.int32)
    jenc, tenc = encoder_out(cfg, jp, tcfg, tp, b)
    tt = torch.from_numpy(toks)
    ref = (W.decoder_forward(tp, tcfg, tt, tenc) if jenc is not None else T.forward(tp, tcfg, tt))
    jc, tc = JD.init_cache(cfg, b, 32), D.init_cache(tcfg, b, 32, device="cpu")
    jl, jc = JD.prefill(jp, cfg, jnp.asarray(toks[:, :s]), jc, enc_out=jenc)
    tl, tc = D.prefill(tp, tcfg, tt[:, :s], tc, enc_out=tenc)
    close(tl, ref[:, s - 1].numpy(), 5e-4)
    close(tl, jl, 1e-4)
    for t in range(4):
        jl, jc = JD.serve_step(jp, cfg, jnp.asarray(toks[:, s + t:s + t + 1]), jc, enc_out=jenc)
        tl, tc = D.serve_step(tp, tcfg, tt[:, s + t:s + t + 1], tc, enc_out=tenc)
        close(tl, ref[:, s + t].numpy(), 5e-4)
        close(tl, jl, 1e-4)
    assert tc["length"] == int(jc["length"]) == s + 4


def test_init_cache_matches_reference():
    for arch in ("zamba2-1.2b", "xlstm-1.3b", "whisper-large-v3"):
        cfg, tcfg = jreg.smoke(arch), registry.smoke(arch)
        for kw in ({}, {"kvswap": True}, {"kvswap": True, "rolling": True}):
            j = JD.init_cache(cfg, 2, 16, kvswap=JD.KVSwapServeConfig(rank=8, rolling=kw.get(
                "rolling", False)) if kw else None)
            t = D.init_cache(tcfg, 2, 16, kvswap=D.KVSwapServeConfig(rank=8, rolling=kw.get(
                "rolling", False)) if kw else None, device="cpu")
            assert set(t) == set(j) and t["length"] == 0
            for ej, et in zip(j["layers"], t["layers"]):
                assert {k: tuple(v.shape) for k, v in et.items()} == \
                    {k: v.shape for k, v in ej.items()}
                for k in et:
                    np.testing.assert_array_equal(et[k].numpy(), np.asarray(ej[k]))


def test_attach_kvswap_adapters():
    cfg = registry.smoke("zamba2-1.2b")
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    out = D.attach_kvswap_adapters(params, cfg, 8, generator=torch.Generator().manual_seed(1))
    assert "kvswap_adapters" not in params and out["blocks"] is params["blocks"]
    feat = cfg.n_kv_heads * cfg.head_dim
    assert len(out["kvswap_adapters"]) == len(cfg.kv_layers)
    for a in out["kvswap_adapters"]:
        assert tuple(a.shape) == (feat, 8)
        torch.testing.assert_close(a.T @ a, torch.eye(8), atol=1e-5, rtol=0)   # orthonormal


def test_kvswap_full_selection_equals_full_attention():
    """M covering every group ⇒ the sparse serve path is exact."""
    cfg = registry.smoke("llama3-8b")
    feat = cfg.n_kv_heads * cfg.head_dim
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = D.attach_kvswap_adapters(params, cfg, feat, generator=torch.Generator().manual_seed(1))
    scfg = D.KVSwapServeConfig(group_size=4, n_select=16, rank=feat)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 28)))
    cf = D.init_cache(cfg, 2, 64, device="cpu")
    ck = D.init_cache(cfg, 2, 64, kvswap=scfg, device="cpu")
    lf, cf = D.prefill(params, cfg, toks[:, :24], cf)
    lk, ck = D.prefill(params, cfg, toks[:, :24], ck, kvswap=scfg)
    close(lk, lf.numpy(), 1e-5)
    for t in range(24, 28):
        lf, cf = D.serve_step(params, cfg, toks[:, t:t + 1], cf)
        lk, ck = D.serve_step(params, cfg, toks[:, t:t + 1], ck, kvswap=scfg)
        close(lk, lf.numpy(), 5e-4)


def test_kvswap_sparse_stays_close():
    """A tight selection keeps the logits strongly correlated with full
    attention's (top-1 agreement is too noisy on a random-init model)."""
    cfg = registry.smoke("llama3-8b")
    feat = cfg.n_kv_heads * cfg.head_dim
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = D.attach_kvswap_adapters(params, cfg, feat, generator=torch.Generator().manual_seed(1))
    scfg = D.KVSwapServeConfig(group_size=4, n_select=4, rank=feat)     # 16 of 24+ tokens
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 25)))
    cf = D.init_cache(cfg, 2, 64, device="cpu")
    ck = D.init_cache(cfg, 2, 64, kvswap=scfg, device="cpu")
    D.prefill(params, cfg, toks[:, :24], cf)
    D.prefill(params, cfg, toks[:, :24], ck, kvswap=scfg)
    lf, _ = D.serve_step(params, cfg, toks[:, 24:25], cf)
    lk, _ = D.serve_step(params, cfg, toks[:, 24:25], ck, kvswap=scfg)
    a = lf.double() - lf.double().mean(-1, keepdim=True)
    b = lk.double() - lk.double().mean(-1, keepdim=True)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    assert float(cos.mean()) > 0.7, cos


def test_rolling_buffer_matches_direct_path():
    """Appends into the rolling buffer, flushed a group at a time, give the
    direct path's logits; after the flushes the main caches agree."""
    cfg = registry.smoke("llama3-8b")
    feat = cfg.n_kv_heads * cfg.head_dim
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = D.attach_kvswap_adapters(params, cfg, feat, generator=torch.Generator().manual_seed(1))
    base = D.KVSwapServeConfig(group_size=4, n_select=16, rank=feat)
    roll = dataclasses.replace(base, rolling=True)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33)))
    c0 = D.init_cache(cfg, 2, 64, kvswap=base, device="cpu")
    c1 = D.init_cache(cfg, 2, 64, kvswap=roll, device="cpu")
    l0, c0 = D.prefill(params, cfg, toks[:, :24], c0, kvswap=base)
    l1, c1 = D.prefill(params, cfg, toks[:, :24], c1, kvswap=roll)
    close(l1, l0.numpy(), 1e-5)
    flushes = 0
    for t in range(24, 33):
        l0, c0 = D.serve_step(params, cfg, toks[:, t:t + 1], c0, kvswap=base)
        l1, c1 = D.serve_step(params, cfg, toks[:, t:t + 1], c1, kvswap=roll)
        close(l1, l0.numpy(), 2e-4)
        if c1["length"] - c1["main_len"] == roll.rb_len:
            c1 = D.flush_rolling(params, cfg, c1, roll)
            flushes += 1
    ml = c1["main_len"]
    assert flushes == 2 and ml == 32 and c1["length"] == 33
    for key in ("k", "v", "k_lr"):
        close(c1["layers"][0][key][:, :ml], c0["layers"][0][key][:, :ml].numpy(), 1e-5)


GIDS_CASES = {"llama3-8b": dict(), "llama3-8b-rolling-prev": dict(rolling=True, predict_from="prev"),
              "zamba2-1.2b": dict(predict_from="prev"), "whisper-large-v3": dict(),
              "olmoe-1b-7b": dict(rolling=True)}


@pytest.mark.parametrize("case", list(GIDS_CASES))
def test_kvswap_selections_equal_reference(case, monkeypatch):
    """Every layer's top-M group ids at every step equal the reference's
    ``jax.lax.top_k`` ids (the -1e30 groups past the flushed tokens tie, and
    both sides keep the lower id first), and the logits agree to 1e-4."""
    arch = case.replace("-rolling-prev", "")
    cfg, jp, tcfg, tp = pair(arch, rank=8)
    kw = dict(group_size=4, n_select=3, rank=8, **GIDS_CASES[case])
    jscfg, tscfg = scfgs(**kw)
    got, want = [], []
    top_k, top = jax.lax.top_k, D._top_groups

    def jtop(x, k):
        sc, ids = top_k(x, k)
        if x.ndim == 2:                  # the groups [B, N/G] (MoE routes over [B, S, E])
            want.append(np.asarray(ids))
        return sc, ids

    def ttop(g, m):
        sc, ids = top(g, m)
        got.append(ids.numpy().copy())
        return sc, ids

    monkeypatch.setattr(jax.lax, "top_k", jtop)
    monkeypatch.setattr(D, "_top_groups", ttop)
    b = 2
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, 33)).astype(np.int32)
    jenc, tenc = encoder_out(cfg, jp, tcfg, tp, b)
    jc = JD.init_cache(cfg, b, 64, kvswap=jscfg)
    tc = D.init_cache(tcfg, b, 64, kvswap=tscfg, device="cpu")
    jl, jc = JD.prefill(jp, cfg, jnp.asarray(toks[:, :24]), jc, kvswap=jscfg, enc_out=jenc)
    tl, tc = D.prefill(tp, tcfg, torch.from_numpy(toks[:, :24]), tc, kvswap=tscfg, enc_out=tenc)
    for t in range(24, 33):
        jl, jc = JD.serve_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc, kvswap=jscfg,
                               enc_out=jenc)
        tl, tc = D.serve_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tc, kvswap=tscfg,
                              enc_out=tenc)
        close(tl, jl, 1e-4)
        if tscfg.rolling and tc["length"] - tc["main_len"] == tscfg.rb_len:
            jc = JD.flush_rolling(jp, cfg, jc, jscfg)
            tc = D.flush_rolling(tp, tcfg, tc, tscfg)
    n_kv = len(tcfg.kv_layers) if not jreg.is_whisper(cfg) else cfg.n_layers
    assert len(got) == len(want) == 9 * n_kv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_step_updates_the_cache_in_place():
    """The reference's ``serve_step`` is functional; the port's writes the
    new entries into the cache it is given and returns the same dict."""
    cfg = registry.smoke("llama3-8b")
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    cache = D.init_cache(cfg, 2, 16, device="cpu")
    _, cache = D.prefill(params, cfg, torch.zeros((2, 8), dtype=torch.int64), cache)
    k_store = cache["layers"][0]["k"]
    assert not k_store[:, 8].any()
    tok = torch.ones((2, 1), dtype=torch.int64)
    _, out = D.serve_step(params, cfg, tok, cache)
    assert out is cache and out["layers"][0]["k"] is k_store and out["length"] == 9
    assert k_store[:, 8].any() and not k_store[:, 9].any()


@pytest.mark.parametrize("kvswap", [False, True], ids=["full", "kvswap-rolling"])
def test_two_copies_of_one_cache_step_alike(kvswap):
    """What replaces the reference's ``test_serve_step_jits_and_is_functional``:
    two steps from two copies of one cache give equal logits and leave equal
    caches, and the copy stays apart from the original."""
    cfg = registry.smoke("zamba2-1.2b")
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    scfg = None
    if kvswap:
        scfg = D.KVSwapServeConfig(group_size=4, n_select=2, rank=8, rolling=True)
        params = D.attach_kvswap_adapters(params, cfg, 8, generator=torch.Generator().manual_seed(1))
    cache = D.init_cache(cfg, 2, 32, kvswap=scfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 13)))
    _, cache = D.prefill(params, cfg, toks[:, :12], cache, kvswap=scfg)
    twin = {**cache, "layers": [{k: t.clone() for k, t in ent.items()} for ent in cache["layers"]]}
    l1, c1 = D.serve_step(params, cfg, toks[:, 12:], cache, kvswap=scfg)
    assert twin["length"] == 12 and c1["length"] == 13
    l2, c2 = D.serve_step(params, cfg, toks[:, 12:], twin, kvswap=scfg)
    assert torch.equal(l1, l2)
    for e1, e2 in zip(c1["layers"], c2["layers"]):
        assert e1.keys() == e2.keys() and all(torch.equal(e1[k], e2[k]) for k in e1)


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b", "whisper-large-v3", "xlstm-1.3b"])
def test_launcher_engine_device(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--engine", "device",
                      "--prompt-len", "24", "--gen-len", "4"])
    assert out.shape == (2, 4) and out.dtype.kind == "i"
    assert "device path (cpu)" in capsys.readouterr().out


def test_device_path_on_cpu():
    """The chip smoke run's device paths, rehearsed at smoke size: ``full``,
    ``kvswap`` and ``kvswap`` with the rolling buffer and cross-layer
    prediction (flushed every G steps), forced tokens and kept logits; no
    kernel launch is counted on the CPU."""
    cfg = registry.smoke("zamba2-1.2b")
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    kw = dict(params=params, device="cpu", batch=2, prompt_len=21, max_new=6, max_len=48)
    full = run_device_path(cfg, "full", keep_logits=True, **kw)
    assert full["tokens"].shape == (2, 6) and full["length"] == 27 and full["logits_finite"]
    assert len(full["logits"]) == 6 and full["prefill_seconds"] > 0
    assert full["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0, "ssd_chunk": 0}
    cover = D.KVSwapServeConfig(group_size=4, n_select=12, rank=8)
    for sc in (cover, dataclasses.replace(cover, rolling=True, predict_from="prev")):
        run = run_device_path(cfg, "kvswap", serve_cfg=sc, forced=full["tokens"],
                              keep_logits=True, **kw)
        np.testing.assert_array_equal(run["tokens"], full["tokens"])
        assert run["flushes"] == (6 // 4 if sc.rolling else 0)
        for a, b in zip(run["logits"], full["logits"]):
            close(a, b.numpy(), 5e-4)
    with pytest.raises(ValueError, match="mode"):
        run_device_path(cfg, "sparse", **kw)
    # n_layers keeps the first blocks; without params the path draws its own from seed
    cut = run_device_path(cfg, "full", **{**kw, "params": None}, n_layers=1)
    assert cut["n_layers"] == 1 and cut["tokens"].shape == (2, 6)
