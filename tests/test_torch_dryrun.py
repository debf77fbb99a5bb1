"""The model's DTensor forward, serving step and train step over a 2×2 and a
1×4 mesh against the plain versions, and the port's dry run
(``launch/dryrun.py``) over the fake 256-rank world.

The mesh checks run as four gloo processes on the CPU, spawned once by a
module fixture (this file run as a script, one rank each; rendezvous
through a file under ``tmp_path``; 120 s deadline).  Each rank lays a smoke
config's params out by the partition rules over a ``("data", "model")``
mesh, runs the step on DTensors and compares the full result with the
plain step on the same values.  Over 2×2: the dense (and a one-KV-head
variant, whose KV heads stay whole while the query heads split), MoE
(OLMoE, Maverick), Mamba2 hybrid, mLSTM/sLSTM and Whisper families; the
decode step batch-sharded and, for Llama, sequence-sharded with and
without KVSwap selection, and for the MoE one row with FSDP weights; the
train step under FSDP specs.  Over 1×4, layouts that split what the rules
leave whole: Whisper with 6 heads (each rank attends with the heads under
its columns), xLSTM with 2 (each head's columns split), Mamba2's heads,
and the MoE with the dry run's ``buf`` hook.  Tolerance: 1e-5 of max(1,
the largest |value|) of the plain result (fp32; the shards sum in another
order).

The fake world runs :func:`repro_torch.launch.dryrun.run_one` at full
width on 16×16, cut in depth by replacing the registry's config (the
widths stay the configs' own), and once through the command line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import dryrun as DR
from repro_torch.sharding import partition as SP

CASES = ["llama3-8b", "llama3-8b-mqa", "olmoe-1b-7b", "zamba2-1.2b", "xlstm-1.3b",
         "whisper-large-v3", "llama4-maverick-400b-a17b"]
# on a 1x4 mesh: heads that do not divide ``model`` (Whisper's 6 over 4 take
# the column layout; xLSTM's 2 split each head's columns), Mamba2's heads
# split over it, and the MoE with the dry run's ``buf`` hook on
CASES_1X4 = ["whisper-6h", "xlstm-2h", "zamba2-1.2b", "llama4-maverick-400b-a17b"]
MESHES = {"2x2": ((2, 2), CASES), "1x4": ((1, 4), CASES_1X4)}
TOL = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _cfg(case: str):
    if case == "llama3-8b-mqa":
        return dataclasses.replace(registry.smoke("llama3-8b"), n_kv_heads=1)
    if case == "whisper-6h":
        return dataclasses.replace(registry.smoke("whisper-large-v3"), n_heads=6, n_kv_heads=6)
    if case == "xlstm-2h":
        return dataclasses.replace(registry.smoke("xlstm-1.3b"), n_heads=2, n_kv_heads=2,
                                   head_dim=64)
    return registry.smoke(case)


# --------------------------------------------------------------------------
# one rank of the 2×2 mesh
# --------------------------------------------------------------------------

def _err(got, want) -> list:
    """``[max |got − want|, max(1, max |want|)]`` over a tensor or a tree."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.treeops import tree_leaves

    g = [t.full_tensor() if isinstance(t, DTensor) else t for t in tree_leaves(got)
         if isinstance(t, torch.Tensor)]
    w = [t for t in tree_leaves(want) if isinstance(t, torch.Tensor)]
    assert len(g) == len(w)
    err = max(float((a.detach().float() - b.float()).abs().max()) for a, b in zip(g, w))
    return [err, max(1.0, max(float(b.float().abs().max()) for b in w))]


def _clone(tree):
    from repro_torch.launch.dryrun import _clone_state

    return _clone_state(tree)


def _distribute(tree, mesh, specs):
    """``distribute_params`` that keeps host ints (a cache's ``length``)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _distribute(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute(v, mesh, s) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, SP.to_placements(mesh, specs))
    return tree


def _check_case(case: str, mesh, *, moe_buf: bool = False) -> dict:
    """Forward, prefill and decode steps and a train step of ``case`` on
    DTensors over ``mesh`` against the plain ones.  ``moe_buf`` turns on the
    dry run's MoE ``buf`` hook for the forward and the train step; an MoE
    case over a mesh with ``data`` also decodes one row with FSDP weights
    (the rows come to the experts' shards)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    from repro_torch.serving import decode as D
    from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.training.train import softmax_xent, value_and_grad
    from repro_torch.utils.treeops import tree_unflatten

    cfg = _cfg(case)
    whisper = registry.is_whisper(cfg)
    params = registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    b, s = 4, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    frames = (torch.from_numpy(rng.standard_normal((b, 16, cfg.d_model)).astype(np.float32))
              if whisper else None)          # 16 frames: the encoder takes any length
    out = {}

    def fwd(p):
        if whisper:
            return W.decoder_forward(p, cfg, toks, W.encode(p, cfg, frames))[0]
        return T.forward(p, cfg, toks)[0]

    dparams = _distribute(params, mesh, SP.param_pspecs(params, mesh))
    hook = {"buf": SP.P("data", None, None, None), "y": SP.P("data", None, None)}
    with implicit_replication():
        L.set_moe_pspecs(hook if moe_buf else None)
        try:
            out["forward"] = _err(fwd(dparams), fwd(params))
        finally:
            L.set_moe_pspecs(None)

    # prefill + one decode step, the cache batch-sharded (and for Llama
    # sequence-sharded at B = 1, with and without the selection)
    scfg = D.KVSwapServeConfig(group_size=4, n_select=3, rank=8) if DR.uses_kvswap(cfg) else None
    kw_params = (D.attach_kvswap_adapters(params, cfg, scfg.rank,
                                          generator=torch.Generator().manual_seed(2))
                 if scfg else params)
    d_kw = _distribute(kw_params, mesh, SP.param_pspecs(kw_params, mesh))
    layouts = [("decode", b, scfg, False)]
    if case == "llama3-8b":
        layouts += [("decode-seq", 1, scfg, True), ("decode-seq-full", 1, None, True)]
    if not whisper and cfg.n_experts and mesh.size(0) > 1:
        layouts += [("decode-seq-fsdp", 1, scfg, True)]   # FSDP weights, one row (long_500k)
    for name, rows, sc, shard_seq in layouts:
        if name.endswith("fsdp"):
            d_kw = _distribute(kw_params, mesh, DR.param_shardings(kw_params, mesh, fsdp=True))
        enc = W.encode(params, cfg, frames[:rows]) if whisper else None
        cache = D.init_cache(cfg, rows, 32, kvswap=sc, device="cpu")
        specs = SP.cache_pspecs(cfg, mesh, shard_seq=shard_seq, kvswap=sc is not None)
        dcache = _distribute(_clone(cache), mesh, specs)
        want_pre, cache = D.prefill(kw_params, cfg, toks[:rows, :10], cache, kvswap=sc,
                                    enc_out=enc)
        prompt = _clone(cache)
        nxt = toks[:rows, 10:11]
        want_step, cache = D.serve_step(kw_params, cfg, nxt, cache, kvswap=sc, enc_out=enc)
        with implicit_replication():
            if shard_seq:       # a prefill never splits the sequence: start from its cache
                dcache = _distribute(prompt, mesh, specs)
            else:
                got_pre, dcache = D.prefill(d_kw, cfg, toks[:rows, :10], dcache, kvswap=sc,
                                            enc_out=enc)
                out[f"{name}/prefill"] = _err(got_pre, want_pre)
            got_step, dcache = D.serve_step(d_kw, cfg, nxt, dcache, kvswap=sc, enc_out=enc)
        out[f"{name}/step"] = _err(got_step, want_step)
        out[f"{name}/cache"] = _err(dcache["layers"], cache["layers"])
        assert dcache["length"] == cache["length"] == 11

    # one train step under the dry run's FSDP specs.  The first AdamW step
    # divides each gradient by its own size plus eps: at the default eps a
    # gradient near 1e-8 turns a last-ulp difference (the shards sum in
    # another order) into a visible step, so the check takes eps 1e-3, where
    # the step is a smooth function of the gradient; the gradients are held
    # to the plain ones themselves as well
    opt_cfg = AdamWConfig(lr=1e-2, eps=1e-3)

    def loss_fn(p, batch):
        if whisper:
            logits, aux = W.decoder_forward(p, cfg, batch["tokens"], W.encode(p, cfg, frames))
        else:
            logits, aux = T.forward(p, cfg, batch["tokens"])
        loss = softmax_xent(logits, batch["targets"])
        return (loss + 0.01 * aux if not whisper and cfg.n_experts else loss), {}

    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}

    def train(p):
        opt = adamw_init(p)
        loss, _, grads = value_and_grad(loss_fn, p, batch)
        p, _ = adamw_update(p, tree_unflatten(p, grads), opt, opt_cfg)
        return loss, grads, p

    want = train(_clone(params))
    specs = DR.param_shardings(params, mesh, fsdp=True)
    with implicit_replication():
        L.set_moe_pspecs(hook if moe_buf else None)
        try:
            got = train(_distribute(_clone(params), mesh, specs))
        finally:
            L.set_moe_pspecs(None)
    for i, what in enumerate(("loss", "grads", "params")):
        out[f"train/{what}"] = _err(got[i], want[i])
    if "slstm" in (getattr(cfg, "block_pattern", None) or ()):
        # 64 tokens a row reach the sLSTM's weight shard (D rows): the weights
        # move to gate-aligned columns, where the steps above move activations
        long = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, 64)))
        with implicit_replication():
            out["forward-weights"] = _err(T.forward(dparams, cfg, long)[0],
                                          T.forward(params, cfg, long)[0])
    return out


def _rank_main(argv=None) -> None:
    from repro_torch.launch.mesh import make_mesh_auto

    ap = argparse.ArgumentParser(description="one rank of the 2x2 DTensor checks")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)            # four ranks on a shared host; the tensors are tiny
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank, world_size=4)
    try:
        results = {}
        for name, (shape, cases) in MESHES.items():
            mesh = make_mesh_auto(shape, ("data", "model"), device="cpu")
            for case in cases:
                results[f"{name}/{case}"] = _check_case(
                    case, mesh, moe_buf=name == "1x4" and case.startswith("llama4"))
        Path(args.out).write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every rank's results, rank 0 first (the processes run this file)."""
    work = tmp_path_factory.mktemp("dtensor")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    outs = [work / f"rank{r}.json" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--init", f"file://{work}/pg", "--out", str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    deadline = time.monotonic() + 120
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.parametrize("case", CASES)
def test_dtensor_steps_match_plain_over_2x2(four_ranks, case):
    _hold(four_ranks, f"2x2/{case}")


@pytest.mark.parametrize("case", CASES_1X4)
def test_dtensor_steps_match_plain_over_1x4(four_ranks, case):
    _hold(four_ranks, f"1x4/{case}")


def _hold(four_ranks, key: str) -> None:
    for rank, res in enumerate(four_ranks):
        assert res[key].keys() >= {"forward", "decode/prefill", "decode/step", "decode/cache",
                                   "train/loss", "train/grads", "train/params"}
        if key == "2x2/llama4-maverick-400b-a17b":
            assert "decode-seq-fsdp/step" in res[key]
        if "xlstm" in key:
            assert "forward-weights" in res[key]
        for what, (err, scale) in res[key].items():
            assert err <= TOL * scale, (rank, key, what, err, scale)


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

def _cut(cfg, blocks: int):
    """``cfg`` at its own widths with its first ``blocks`` blocks."""
    if registry.is_whisper(cfg):
        return dataclasses.replace(cfg, n_layers=blocks, n_enc_layers=blocks)
    if cfg.block_pattern:
        return dataclasses.replace(cfg, n_layers=blocks, block_pattern=cfg.block_pattern[:blocks])
    return dataclasses.replace(cfg, n_layers=blocks)


FAMILIES = {"llama3-8b": 2, "olmoe-1b-7b": 2, "zamba2-1.2b": 6, "xlstm-1.3b": 8,
            "whisper-large-v3": 1}


@pytest.fixture
def cut_registry(monkeypatch):
    get = registry.get
    monkeypatch.setattr(registry, "get", lambda a: _cut(get(a), FAMILIES[a]))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_run_one_on_the_fake_world(cut_registry, monkeypatch, arch):
    """Decode at full width and depth cut, and train (xLSTM's at 128 tokens:
    its scans are traced token by token and chunk by chunk).  An xLSTM
    prefill of 2^20 tokens would be over the trace budget: it is reported
    ``not run``, naming the blocks that loop."""
    import torch.distributed as tdist

    res = DR.run_one(arch, "decode_32k", verbose=False)
    assert res.ok, res.error
    assert res.flops > 0 and res.bytes_accessed > 0 and res.lower_s > 0 and res.compile_s == 0
    assert res.memory["argument_bytes"] > 0 and res.memory["code_bytes"] == 0
    assert not tdist.is_initialized()
    if arch == "xlstm-1.3b":
        monkeypatch.setitem(DR.SHAPES, "train_4k",
                            dataclasses.replace(DR.SHAPES["train_4k"], seq_len=128))
    res = DR.run_one(arch, "train_4k", verbose=False)
    assert res.ok, res.error
    assert res.collective_bytes > 0
    assert not tdist.is_initialized()
    if arch == "xlstm-1.3b":
        monkeypatch.setitem(DR.SHAPES, "prefill_32k",
                            dataclasses.replace(DR.SHAPES["prefill_32k"], seq_len=2 ** 20))
        res = DR.run_one(arch, "prefill_32k", verbose=False)
        assert not res.ok and res.error.startswith("not run:"), res.error
        assert "1 sLSTM blocks" in res.error and "7 mLSTM blocks" in res.error


def test_llama_decode_collectives_follow_the_partition_rules(cut_registry):
    """llama3-8b × decode_32k × 16x16 at two layers, counted from the
    rules: B 128 over 16 ``data`` rows → 8 local rows, bf16, ``model`` 16.
    Each layer all-gathers its q, k and v projections (their columns split
    over ``model``; the cache keeps every KV head and the selection scores
    every query head) and all-reduces its two row-parallel outputs (the
    attention's ``wo`` and the MLP's ``w_down``); the vocab-parallel
    embedding all-reduces once; the head's logits stay split over
    ``model``.  Nothing else moves."""
    res = DR.run_one("llama3-8b", "decode_32k", verbose=False)
    c, n = res.collectives, res.collectives["_counts"]
    rows, d, kv, layers, m, bf16 = 8, 4096, 8 * 128, 2, 16, 2
    assert c["all-gather"] == layers * rows * (d + 2 * kv) // m * bf16
    assert c["all-reduce"] == (1 + 2 * layers) * rows * d * bf16
    assert c["reduce-scatter"] == c["all-to-all"] == c["collective-permute"] == 0
    assert c["total"] == res.collective_bytes == c["all-gather"] + c["all-reduce"]
    assert n == {"all-gather": 3 * layers, "all-reduce": 1 + 2 * layers, "reduce-scatter": 0,
                 "all-to-all": 0, "collective-permute": 0}


def _layer_counts(build, step, x_shape, *, fsdp: bool = False, moe_buf: bool = False) -> dict:
    """``step(params, x)`` on the fake 16x16 world at full width: ``build()``
    (under fake tensors) lays the params out by the dry run's rules, ``x``
    bf16 with its rows over ``data`` where they divide → ``DR.measure``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_fake_production_mesh
    from repro_torch.models import layers as L

    with fake_world(256):
        mesh = make_fake_production_mesh()
        L.set_moe_pspecs({"buf": SP.P("data", None, None, None), "y": SP.P("data", None, None)}
                         if moe_buf else None)
        try:
            with FakeTensorMode():
                params = build()
                x = torch.empty(x_shape, dtype=torch.bfloat16)
                rows = "data" if x_shape[0] % 16 == 0 else None
                return DR.measure(step, (params, x), (DR.param_shardings(params, mesh, fsdp=fsdp),
                                                      SP.P(rows, None, None)), mesh)
        finally:
            L.set_moe_pspecs(None)


def _layout(name: str):
    """``(counts, expected all-gather / all-to-all / all-reduce bytes and
    counts)`` of one layout, the expectation derived from the layout: rows
    B 256 over 16 ``data`` → 16 a rank, ``model`` 16, bf16 activations,
    fp32 state and statistics."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    kw = dict(generator=torch.Generator(), device="cpu", dtype=torch.bfloat16)
    rows, bf16, f32 = 16, 2, 4
    if name == "whisper-attention":
        # 20 heads of 64 over 16: q, k, v come whole (3 all-gathers of a
        # rank's 80 columns); each rank attends with the 2 heads under its
        # 80 output columns, which leave split: nothing else moves
        s = 32
        got = _layer_counts(
            lambda: {"attn": L.init_attention(d_model=1280, n_heads=20, n_kv_heads=20,
                                              head_dim=64, **kw)},
            lambda p, x: L.attention(p["attn"], x, None, n_heads=20, n_kv_heads=20, head_dim=64,
                                     attend=L.causal_attention)[0], (256, s, 1280))
        flops = 3 * 2 * rows * s * 1280 * 80 + 2 * 2 * rows * 2 * s * s * 64
        return got, {"all-gather": (3, 3 * rows * s * 80 * bf16)}, flops
    if name == "mamba2-heads":
        # Zamba2's mixer: in_proj's output whole (its 8384 columns, 524 a
        # rank), the conv weights and biases whole (264 channels a rank),
        # the gated norm's sum of squares over model, and the conv window of
        # the rank's 256 x channels gathered for the cache: 5 all-gathers
        s = 128
        got = _layer_counts(lambda: {"mamba": S.init_mamba2(d_model=2048, d_state=64, **kw)},
                            lambda p, x: S.mamba2_forward(p["mamba"], x)[0], (256, s, 2048))
        nbytes = (rows * s * 524 * bf16 + 264 * 4 * bf16 + 264 * bf16 + rows * s * f32
                  + rows * 256 * 3 * bf16)
        return got, {"all-gather": (5, nbytes)}, None
    if name == "xlstm-columns":
        # mLSTM: q and k whole, v's 128 columns a rank (a quarter of a head
        # of 512): the head norm's sums over [B, S, 4 heads] and the state
        # (c's [1 head, 512, 128] a rank, n, m) gathered back whole.  sLSTM
        # at 16 rows x 16 tokens, fewer than its weight shard's 2048 rows
        # (moves_activations): each token's pre-activations over the rank's
        # 512 columns to gate-aligned columns by one all-to-all, h [128, B]
        # gathered and the i and f head means summed over model every token,
        # the norm's sums, then c, n, h and m; between the blocks the
        # mLSTM's output, a partial sum over model, is reduced
        s = 16
        got = _layer_counts(
            lambda: {"mlstm": S.init_mlstm(d_model=2048, n_heads=4, **kw),
                     "slstm": S.init_slstm(d_model=2048, n_heads=4, **kw)},
            lambda p, x: S.slstm_forward(p["slstm"], S.mlstm_forward(p["mlstm"], x)[0])[0],
            (256, s, 2048))
        m_bytes = (2 * rows * s * 128 * bf16 + rows * s * 4 * f32
                   + rows * 512 * 128 * f32 + rows * 512 * f32 + rows * f32)
        s_bytes = (s * 128 * rows * f32 + s * rows * 2 * 4 * f32
                   + rows * s * 4 * f32 + 3 * 128 * rows * f32 + rows * f32)
        return got, {"all-gather": (6 + 2 * s + 5, m_bytes + s_bytes),
                     "all-to-all": (s, s * 4 * 128 * rows * f32),
                     "all-reduce": (1, rows * s * 2048 * bf16)}, None
    moe = lambda: {"blocks": [{"moe": L.init_moe(d_model=5120, d_ff=8192, n_experts=128, **kw)}]}
    step = lambda p, x: L.moe(p["blocks"][0]["moe"], x, top_k=1)[0]
    if name == "moe-buf":
        # the buf hook: the experts' outputs (8 experts a rank, capacity 1 at
        # 64 tokens) gathered whole before the combine, and the loss
        # statistics' one all-reduce
        got = _layer_counts(moe, step, (256, 64, 5120), moe_buf=True)
        return got, {"all-gather": (1, rows * 8 * 1 * 5120 * bf16),
                     "all-reduce": (1, 128 * f32)}, None
    # one row, FSDP: the experts stay split over data; the row comes to them
    # and each rank's gate and up products are summed over data (2
    # all-gathers of [8 experts, 8192]), the router gathered over data,
    # and the statistics reduced over both axes
    got = _layer_counts(moe, step, (1, 1, 5120), fsdp=True)
    return got, {"all-gather": (3, 5120 // 16 * 128 * bf16 + 2 * 8 * 8192 * bf16),
                 "all-reduce": (2, 2 * 128 * f32)}, None


@pytest.mark.parametrize("name", ["whisper-attention", "mamba2-heads", "xlstm-columns",
                                  "moe-buf", "moe-fsdp-one-row"])
def test_layout_collectives_follow_the_layout(name):
    """Each layout that splits what the partition rules leave whole, on
    one layer at full width over 16x16: the collectives it runs, counted
    from the layout (and for the column layout its FLOPs)."""
    got, want, flops = _layout(name)
    c = got["collectives"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        n, nbytes = want.get(kind, (0, 0))
        assert (c["_counts"][kind], c[kind]) == (n, nbytes), (name, kind, c)
    if flops is not None:
        assert got["flops"] == flops


def test_one_rank_dry_run_counts_the_plain_step():
    """The dry run at a world of one (the card check's form) against the
    same decode step run for real on the CPU: its argument bytes are the
    real params', adapters', cache's and tokens' bytes, and its FLOPs are
    ``FlopCounterMode``'s over the real step, exactly."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.serving import decode as D
    from repro_torch.utils.treeops import tree_leaves

    cfg = registry.smoke("llama3-8b")
    serve = D.KVSwapServeConfig(group_size=4, n_select=3, rank=8)
    b, max_len, length = 2, 64, 40
    got = DR.decode_one_rank(cfg, b, max_len, length, serve=serve)
    params = D.attach_kvswap_adapters(
        registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        cfg, serve.rank, generator=torch.Generator().manual_seed(1))
    cache = D.init_cache(cfg, b, max_len, kvswap=serve, device="cpu")
    cache["length"] = length
    toks = torch.zeros((b, 1), dtype=torch.int32)
    real = sum(t.numel() * t.element_size() for t in tree_leaves((params, toks, cache))
               if isinstance(t, torch.Tensor))
    with FlopCounterMode(display=False) as fc:
        logits, _ = D.serve_step(params, cfg, toks, cache, kvswap=serve)
    assert got["memory"]["argument_bytes"] == real
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["memory"]["output_bytes"] >= logits.numel() * 4
    assert not dist.is_initialized()


def test_fake_world_is_destroyed_on_failure():
    from repro_torch.launch.mesh import fake_world

    with pytest.raises(ValueError, match="boom"):
        with fake_world(256):
            assert dist.get_world_size() == 256
            raise ValueError("boom")
    assert not dist.is_initialized()


def test_importing_the_port_sets_nothing():
    """Unlike the reference's dry run (its line 2 sets ``XLA_FLAGS``),
    importing every module of the port — the dry run and the fake world
    among them — changes no environment variable and starts no process
    group."""
    code = ("import importlib, json, os, pkgutil\n"
            "before = dict(os.environ)\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import torch.distributed as d\n"
            "print(json.dumps({'env': dict(os.environ) == before, 'pg': d.is_initialized(),\n"
            "                  'dryrun': 'repro_torch.launch.dryrun' in __import__('sys').modules}))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"env": True, "pg": False,
                                                              "dryrun": True}


def test_cli_writes_the_reference_schema(tmp_path):
    out = tmp_path / "dry.json"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-8b",
                          "--shape", "decode_32k", "--out", str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "[ok] llama3-8b × decode_32k × 16x16" in run.stdout
    assert "1/1 combinations" in run.stdout
    (res,) = json.loads(out.read_text())
    assert set(res) == {"arch", "shape", "mesh", "kvswap", "ok", "error", "lower_s", "compile_s",
                        "flops", "bytes_accessed", "collective_bytes", "collectives", "memory"}
    assert res["ok"] and res["kvswap"] and res["mesh"] == "16x16"
    assert set(res["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                       "collective-permute", "total", "_counts"}
    assert set(res["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes"}
    assert res["memory"]["argument_bytes"] == 36_441_956_384


if __name__ == "__main__":
    _rank_main()
