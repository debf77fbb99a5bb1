"""The port's training substrate (``training/optim.py``, ``training/train.py``,
``launch/train.py`` and kernel C's gradient, ``ops.SSDChunk``) against the
JAX package's, on the same weights (through the bridge) and the same numpy
inputs.

Tolerances, fp32 on both sides: the schedule and the global norm to 1e-6
relative; AdamW updates on identical grads to 1e-6 relative plus 1e-6 of
the leaf's largest magnitude (elementwise arithmetic, where a moment's sum
may cancel; the step-1 ratio ``m̂/√v̂`` is ±1 wherever |g| ≫ eps, so the
grads are drawn away from eps); the loss to 1e-5 relative and each param's gradient
to 5e-5 of that leaf's largest |g| (XLA's fused blocks and PyTorch's eager
ones round differently by a few ulps per op through two blocks: the
largest difference seen is 5.7e-6 of a leaf's scale).  Kernel C's backward
against ``jax.vjp`` of the reference's oracle ``ssd_chunk_ref`` to 1e-4 of
``max(1, |g|max)``, as kernel C's forward is held.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import SyntheticLMStream as JStream
from repro.kernels.ref import ssd_chunk_ref
from repro.models import whisper as JW
from repro.models.transformer import ModelConfig as JModelConfig, forward as jforward
from repro.models.transformer import init_params as jinit
from repro.training import optim as JO
from repro.training.train import TrainState as JTrainState, make_loss_fn as jloss_fn
from repro.training.train import make_train_step as jmake_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.training.optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                                        cosine_lr, global_norm)
from repro_torch.training.train import (TrainState, value_and_grad, make_loss_fn,
                                        make_train_step, softmax_xent, train_loop)
from repro_torch.utils.treeops import tree_leaves, tree_unflatten

TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=97)
MODELS = ["tiny", "olmoe-1b-7b", "zamba2-1.2b", "whisper-large-v3"]


def to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def jax_order(tree):
    """A port tree's leaves as numpy, in ``jax.tree_util``'s order (sorted keys)."""
    return [t.detach().numpy() for t in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def model(name):
    """``(reference cfg, port cfg, reference params, port params, reference
    forward, port forward)``; Whisper's forwards close over ``encode`` of
    the same seeded frames, as both launchers train it."""
    if name == "tiny":
        jcfg, cfg = JModelConfig(**TINY), T.ModelConfig(**TINY)
        jp = jinit(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg, cfg = jreg.smoke(name), registry.smoke(name)
        jp = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    jf, tf = jforward, T.forward
    if name.startswith("whisper"):
        frames = np.random.default_rng(9).standard_normal(
            (2, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)
        jf = lambda p, c, t: JW.decoder_forward(p, c, t, JW.encode(p, c, jnp.asarray(frames)))
        tf = lambda p, c, t: W.decoder_forward(p, c, t, W.encode(p, c, torch.from_numpy(frames)))
    return jcfg, cfg, jp, to_port(jp), jf, tf


def batches(vocab, b, s, step=0):
    np_batch = SyntheticLMStream(vocab, seed=4).batch(step, b, s)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v).long() for k, v in np_batch.items()})


# -- optimizer arithmetic ----------------------------------------------------------

def test_cosine_lr_matches_reference():
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        got = float(cosine_lr(step, base_lr=3e-3, warmup=10, total=100))
        want = float(JO.cosine_lr(jnp.asarray(step), base_lr=3e-3, warmup=10, total=100))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(cosine_lr(torch.tensor(0, dtype=torch.int32), base_lr=1.0, warmup=0,
                           total=4)) == 0.0


def grads_like(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in shapes.items():
        g = rng.standard_normal(shp).astype(np.float32) * scale
        out[k] = np.where(np.abs(g) < 1e-3, 1e-3, g).astype(np.float32)   # away from eps
    return out


SHAPES = {"w": (17, 9), "b": (9,), "emb": (33, 4)}


def test_global_norm_and_clip_match_reference():
    g = grads_like(SHAPES, 1, scale=3.0)
    np.testing.assert_allclose(float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})),
                               float(JO.global_norm({k: jnp.asarray(v) for k, v in g.items()})),
                               rtol=1e-6)
    # a huge gradient is clipped to norm grad_clip: the step stays bounded
    p = {"w": torch.zeros(1)}
    adamw_update(p, {"w": torch.tensor([1e6])}, adamw_init(p),
                 AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0))
    assert abs(float(p["w"][0])) < 2.0


def test_adamw_update_matches_reference():
    """Three updates on identical grads, with clipping active on the second
    and a schedule's lr on the third: params and both moments."""
    p0 = grads_like(SHAPES, 2)
    cfg = AdamWConfig(lr=1e-2, grad_clip=5.0)
    jcfg = JO.AdamWConfig(lr=1e-2, grad_clip=5.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = JO.adamw_init(jp), adamw_init(tp)
    for i, scale in enumerate((0.1, 10.0, 1.0)):
        g = grads_like(SHAPES, 10 + i, scale)
        lr = None if i < 2 else 3e-3
        jp, js = JO.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg, lr=lr)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tp, ts = adamw_update(tp, tg, ts, cfg, lr=lr)
        assert all(np.array_equal(tg[k].numpy(), g[k]) for k in g)     # grads untouched
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(want).max()))
    assert int(ts.step) == int(js.step) == 3


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        params, state = adamw_update(params, {"w": 2 * params["w"]}, state,
                                     AdamWConfig(lr=0.1, weight_decay=0.0))
    assert float(params["w"].abs().max()) < 0.1


# -- loss and gradients ------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_reference(name):
    """One batch's loss (with OLMoE's load-balance loss) and every param's
    gradient against ``jax.value_and_grad`` of the reference's loss."""
    jcfg, cfg, jp, tp, jf, tf = model(name)
    jb, tb = batches(jcfg.vocab_size, 2, 16)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss_fn(jf, jcfg), has_aux=True))(jp, jb)
    tl, tm, tg = value_and_grad(make_loss_fn(tf, cfg), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    if name == "olmoe-1b-7b":
        assert float(tm["aux"]) > 0
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    got = jax_order(tree_unflatten(tp, tg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5 * max(1e-30, float(np.abs(b).max())))


def test_softmax_xent():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5))
    from repro.training.train import softmax_xent as jxent
    np.testing.assert_allclose(float(softmax_xent(torch.from_numpy(logits), torch.from_numpy(tgt))),
                               float(jxent(jnp.asarray(logits), jnp.asarray(tgt))), rtol=1e-6)


def test_remat_equals_no_remat():
    _, cfg, _, tp, _, _ = model("zamba2-1.2b")
    _, tb = batches(cfg.vocab_size, 2, 16)
    remat = lambda p, c, t: T.forward(p, c, t, remat=True)
    l0, _, g0 = value_and_grad(make_loss_fn(T.forward, cfg), tp, tb)
    l1, _, g1 = value_and_grad(make_loss_fn(remat, cfg), tp, tb)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_train_step_matches_reference_step():
    """One step of each package's ``make_train_step`` from the same params
    (lr is 0 at step 0, so the params move by decay·0; the moments carry the
    clipped grads) and a second step's loss."""
    jcfg, cfg, jp, tp, jf, tf = model("tiny")
    jstep = jmake_step(jf, jcfg, JO.AdamWConfig(lr=1e-3), total_steps=4, warmup=1)
    tstep = make_train_step(tf, cfg, AdamWConfig(lr=1e-3), total_steps=4, warmup=1)
    js, ts = JTrainState(jp, JO.adamw_init(jp)), TrainState(tp, adamw_init(tp))
    for step in range(2):
        jb, tb = batches(jcfg.vocab_size, 4, 16, step)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in zip(jax_order(ts.opt.mu), jax.tree_util.tree_leaves(js.opt.mu)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * float(np.abs(want).max()))


def test_grad_accumulation_matches_full_batch():
    """``accum_steps=2`` over a 2× microbatch split gives the full batch's
    loss and grads, as the reference's test holds them (loss to 1e-5, params
    to 2e-6); the microbatch grads, averaged, to 1e-6 of their scale."""
    _, cfg, _, tp, _, tf = model("tiny")
    _, tb = batches(cfg.vocab_size, 8, 16)
    _, _, g_full = value_and_grad(make_loss_fn(tf, cfg), tp, tb)
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in tb.items()} for i in range(2)]
    g_half = [value_and_grad(make_loss_fn(tf, cfg), tp, h)[2] for h in halves]
    for a, b, c in zip(g_full, *g_half):
        assert float(((b + c) / 2 - a).abs().max()) <= 1e-6 * max(1e-30, float(a.abs().max()))
    clone = lambda: tree_unflatten(tp, [t.detach().clone() for t in tree_leaves(tp)])
    full = make_train_step(tf, cfg, AdamWConfig(lr=1e-3), total_steps=4)
    acc = make_train_step(tf, cfg, AdamWConfig(lr=1e-3), total_steps=4, accum_steps=2)
    s_full, m_full = full(TrainState(p := clone(), adamw_init(p)), tb)
    s_acc, m_acc = acc(TrainState(p := clone(), adamw_init(p)), tb)
    assert abs(float(m_full["loss"]) - float(m_acc["loss"])) < 1e-5
    for a, b in zip(tree_leaves(s_full.params), tree_leaves(s_acc.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-6)


def test_loss_decreases_on_tiny_model():
    """The reference's 80-step test, in the port."""
    _, cfg, _, tp, _, tf = model("tiny")
    stream = SyntheticLMStream(cfg.vocab_size, seed=3)
    step = make_train_step(tf, cfg, AdamWConfig(lr=5e-3), total_steps=80, warmup=5)
    state, losses = TrainState(tp, adamw_init(tp)), []
    for i in range(80):
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in stream.batch(i, 8, 32).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_train_loop_prints_the_reference_lines(capsys):
    jcfg, cfg, jp, tp, jf, tf = model("tiny")
    JStream_, kw = JStream(jcfg.vocab_size, seed=1), dict(steps=3, batch=4, seq_len=16, log_every=1)
    from repro.training.train import train_loop as jtrain_loop
    _, jhist = jtrain_loop(jp, jf, jcfg, JStream_, **kw)
    want = capsys.readouterr().out.splitlines()
    state, hist = train_loop(tp, tf, cfg, SyntheticLMStream(cfg.vocab_size, seed=1), **kw,
                             device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2]
    for g, w, h, jh in zip(got, want, hist, jhist):
        assert g.split()[::2] == w.split()[::2] == ["step", "loss", "lr"]
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(h["lr"], jh["lr"], rtol=1e-6)
    assert isinstance(state.opt, AdamWState) and int(state.opt.step) == 3


# -- kernel C's gradient ------------------------------------------------------------

def ssd_inputs(seed, b=2, nc=2, q=16, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    cm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    dt = rng.random((b, nc, q, h)).astype(np.float32)
    cum = np.cumsum(-dt * rng.random(h).astype(np.float32), axis=2).astype(np.float32)
    return [xh, bm, cm, dt, cum]


def test_ssd_chunk_backward_matches_reference_vjp():
    """``ops.ssd_chunk`` (``SSDChunk``) on CPU tensors: its grads in all five
    inputs equal autograd of ``ssd_chunk_plain``, and ``jax.vjp`` of the
    reference's oracle within 1e-4 of max(1, |g|max); no launch is counted,
    and under ``no_grad`` nothing is kept for a backward."""
    args = ssd_inputs(0)
    cot = np.random.default_rng(1).standard_normal((2, 2, 16, 3, 8)).astype(np.float32)
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    before = ops.ssd_chunk.launches
    got = torch.autograd.grad(ops.ssd_chunk(*t_args), t_args, torch.from_numpy(cot))
    want_plain = torch.autograd.grad(ops.ssd_chunk_plain(*t_args), t_args, torch.from_numpy(cot))
    _, vjp = jax.vjp(ssd_chunk_ref, *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(cot))
    for g, gp, w in zip(got, want_plain, want):
        assert torch.equal(g, gp)
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()))
    assert ops.ssd_chunk.launches == before
    with torch.no_grad():
        y = ops.ssd_chunk(*t_args)
    assert y.grad_fn is None and not y.requires_grad


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with a
    checkpoint directory; the final checkpoint loads into fresh params."""
    from repro_torch.checkpoint import load_pytree

    hist = launch_train.main(["--arch", "zamba2-1.2b", "--smoke", "--steps", "3", "--batch", "2",
                              "--seq-len", "16", "--device", "cpu",
                              "--checkpoint", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and np.isfinite(hist[-1]["loss"])
    cfg = registry.smoke("zamba2-1.2b")
    tmpl = registry.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    restored = load_pytree(os.path.join(tmp_path, "final.npz"), tmpl)
    assert restored["embed"].shape == tmpl["embed"].shape
    assert not torch.equal(restored["embed"], tmpl["embed"])
