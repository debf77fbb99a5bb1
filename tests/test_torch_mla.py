"""Multi-head latent attention (MLA) with a share of routed experts through
the port's KVSwap path, at a tiny size on the CPU, against the plain
reference of the benchmark (``kvbench/reference/mla.py``).

The tiny configuration keeps Mistral-Small-4's configuration file and
shrinks its widths: d 64, 4 heads, ``q_lora`` 32, ``kv_lora`` 16, nope 8,
rope 8, v 16, 16 routed experts of which 8 are held, top-2, one shared
expert, YaRN over an original context of 128.  A latent record is 24
floats.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from kvbench import check, weights, workload
from kvbench.models import mla as family
from kvbench.reference import mla as ref
from kvbench.run import choices
from repro_torch import main_path
from repro_torch.core import tuner
from repro_torch.core.engine import KVSwapEngine
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerAdapter, forward
from repro_torch.obs import Observability
from repro_torch.serving import ServeSession

ROOT = Path(__file__).resolve().parents[1]
FULL = json.loads((ROOT / "kvbench" / "configs" / "mistral-small-4-119b.json").read_text())
TINY = dict(FULL, hidden_size=64, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, qk_head_dim=16,
            head_dim=16, v_head_dim=16, n_routed_experts=8, num_experts=8,
            n_routed_experts_published=16, num_experts_per_tok=2, moe_intermediate_size=32,
            intermediate_size=96, vocab_size=256, num_hidden_layers=2,
            rope_parameters=dict(FULL["rope_parameters"], factor=4,
                                 original_max_position_embeddings=128),
            engine=dict(group_size=4, n_select=3, rank=12, reuse_capacity=2, max_seq=128,
                        device_resident=True, async_io=True, io_threads=2, disk="nvme",
                        calib_tokens=32))
RECORD = 16 + 8
SEED = 2**31 + 11


def tiny(**engine) -> dict:
    return {**TINY, "engine": {**TINY["engine"], **engine}}


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def w():
    return weights.nested(weights.make(family.leaves(TINY), SEED, "cpu"))


def build(cfg: dict, w: dict):
    """The program on the benchmark's weights, and its adapter's
    calibration records (layer 0's, on the seed's calibration prompt)."""
    model = TransformerAdapter(family.port_config(cfg, cfg["engine"]))
    params = family.port_params(cfg, w)
    calib = torch.as_tensor(workload.calibration(SEED, cfg["vocab_size"],
                                                 cfg["engine"]["calib_tokens"]))[None]
    _, k0, _ = model.prefill_block(params, 0, model.embed(params, calib),
                                   torch.arange(calib.shape[1])[None])
    return model, params, k0[0].numpy()


def serve(cfg: dict, w: dict, prompts: list, n_new: int, monkeypatch, obs=None) -> tuple:
    """Prompts admitted together through ``ServeSession``, decoded greedily;
    returns the requests in the form :func:`kvbench.check.compare` takes
    (the program's own selections and routes, as ``kvbench/run.py`` observes
    them) and the session, open."""
    model, params, calib_k = build(cfg, w)
    sess = ServeSession(model, params, family.engine_config(cfg["engine"]), slots=len(prompts),
                        calib_k=calib_k, obs=obs, device="cpu")
    eng = sess.engine
    picks, routes_decode, routes_admit, ctx = {}, {}, {}, {"admit": None, "decode": None}

    def observe(layer, x, pos, table):
        ctx["decode"] = (len(eng.step_log), layer)
        picks[ctx["decode"]] = (table.group_ids.copy(), table.group_mask.copy())

    real = L._moe_dispatch

    def dispatch(*args, **kwargs):
        out = real(*args, **kwargs)
        if ctx["admit"] is not None:
            ctx["admit"].append(out[1])
        elif ctx["decode"] is not None:
            routes_decode[ctx["decode"]] = out[1].clone()
        return out

    admit_row = eng.admit_row

    def admit(bi, *args, **kwargs):
        ctx["admit"] = []
        out = admit_row(bi, *args, **kwargs)
        routes_admit[len(eng.step_log), bi] = ctx["admit"]
        ctx["admit"] = None
        return out

    monkeypatch.setattr(L, "_moe_dispatch", dispatch)
    eng.admit_row, eng.layer_hook = admit, observe
    logits = {}

    def sampler_for(rid):
        def sample(lg):
            logits.setdefault(rid, []).append(np.asarray(lg))
            return np.asarray(lg).argmax(-1)
        return sample

    rids = [sess.submit(p, n_new, sampler=sampler_for(i)) for i, p in enumerate(prompts)]
    served = {r: [] for r in rids}
    while sess.has_work:
        for ev in sess.step():
            if ev["type"] == "token":
                served[ev["rid"]].append(ev["token"])
    requests = [choices({"prompt": prompts[r], "served": np.asarray(served[r]),
                         "logits": np.concatenate(logits[r])}, picks, routes_admit,
                        routes_decode, 0, r, model.n_layers, cfg["engine"]["group_size"], True)
                for r in rids]
    return requests, sess


def prompts_for(cfg: dict, lengths=(37, 50)) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg["vocab_size"], n) for n in lengths]


@pytest.mark.parametrize("resident,async_io", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_served_logits_match_the_reference(w, monkeypatch, resident, async_io):
    """Prefill then decode through ``ServeSession``: every served logit
    within 1e-5 of the reference (relative to the row's largest), following
    the program's own group selections and routes, each of them a top
    choice under the reference's own numbers."""
    cfg = tiny(device_resident=resident, async_io=async_io)
    requests, sess = serve(cfg, w, prompts_for(cfg), 16, monkeypatch)
    sess.close()
    got = check.compare(w, cfg, requests, SEED, "cpu")
    assert got["missing"] == 0 and got["tokens"] == 32
    assert got["error"] <= 1e-5, got
    assert got["slack"] == 0.0 and got["routing_slack"] == 0.0, got


def test_full_selection_decodes_as_the_full_forward(w, monkeypatch):
    """With ``M·G`` covering the whole context every group is attended:
    decode gives the full causal forward's logits (the program's own and
    the reference's with every group)."""
    cfg = tiny(n_select=32)
    prompt = prompts_for(cfg, (29,))
    (req,), sess = serve(cfg, w, prompt, 12, monkeypatch)
    sess.close()
    tokens = torch.as_tensor(np.concatenate([req["prompt"], req["served"][:-1]]))
    pcfg = family.port_config(cfg, cfg["engine"])
    full, _ = forward(family.port_params(cfg, w), pcfg, tokens[None])
    served = torch.as_tensor(req["logits"])
    assert float((served - full[0, len(prompt[0]) - 1:]).abs().max()) < 1e-4
    calib = torch.as_tensor(workload.calibration(SEED, 256, 32))
    want = ref.served_logits(w, cfg, cfg["engine"], ref.fit_adapter(w, cfg, calib, 12), tokens,
                             len(prompt[0]))
    assert float((served - want).abs().max()) < 1e-4


def test_lossless_adapter_scores_the_exact_logit(w):
    """With ``r = kv_lora + rope`` the adapter loses nothing: the absorbed
    query's score of a record through it is the exact ``q · k`` logit of the
    decompressed heads, summed over heads, and the engine selects the exact
    top-M groups."""
    cfg = tiny(rank=RECORD)
    model, params, calib_k = build(cfg, w)
    eng = KVSwapEngine(model, params, family.engine_config(cfg["engine"]), batch=1,
                       calib_k=calib_k, device="cpu")
    assert eng.adapter.rank == RECORD
    prompt = prompts_for(cfg, (41,))[0]
    eng.admit_row(0, prompt)
    x = model.embed(params, torch.as_tensor(prompt)[None])
    pos = torch.arange(41)[None]
    _, rec, _ = model.prefill_block(params, 0, x, pos)
    attn = params["blocks"][0]["attn"]
    h = L.rmsnorm(params["blocks"][0]["attn_norm"], x[:, -1])
    q = L.mla_queries(attn, h, torch.tensor([41]), n_heads=4, nope=8,
                      inv_freq=model.cfg.rope_inv_freq())
    k, _ = L.mla_expand(attn, rec[0, :, 0], n_heads=4, nope=8)
    exact = torch.einsum("hd,thd->t", q[0], k)
    q_abs = model.predict_query(params, 0, x[:, -1], torch.tensor([41]))
    a = eng.adapter.a
    scored = torch.einsum("hd,dr,tr->t", q_abs[0], a, rec[0, :, 0] @ a)
    assert float((scored - exact).abs().max()) <= 1e-4 * float(exact.abs().max())
    ids, mask = eng._predict(0, q_abs, torch.tensor([40], dtype=torch.int32))
    best = exact[:40].reshape(10, 4).amax(dim=1).argsort(descending=True)[:3]
    assert set(ids[0][mask[0]].tolist()) == set(best.tolist())
    eng.close()


def test_expert_shares_add_up_to_the_uncut_layer(w):
    """Two cards' shares of a 16-expert layer (experts 0-7 and 8-15), each
    routing over all 16 and computing its own experts' part, with the
    shared expert counted once, give the uncut reference layer."""
    torch.manual_seed(0)
    d, f, e = 64, 32, 16
    lw = {"router": torch.randn(d, e) * 0.3, "w_gate": torch.randn(e, d, f) / 8,
          "w_up": torch.randn(e, d, f) / 8, "w_down": torch.randn(e, f, d) / 6,
          "shared_gate": torch.randn(d, f) / 8, "shared_up": torch.randn(d, f) / 8,
          "shared_down": torch.randn(f, d) / 6}
    h = torch.randn(1, 23, d)
    parts = [L._moe_routed(lw["router"], *(lw[k][e0:e0 + 8] for k in ("w_gate", "w_up",
                                                                       "w_down")),
                           h, top_k=2, capacity_factor=0.0, score="sigmoid", e0=e0)[0]
             for e0 in (0, 8)]
    shared = L.swiglu({k: lw["shared_" + k[2:]] for k in ("w_gate", "w_up", "w_down")}, h)
    dm = ref.Dims(dict(TINY, n_routed_experts=16))
    uncut = ref.ffn(lw, dm, h[0], ref.route(lw, dm, h[0]))
    assert float((parts[0] + parts[1] + shared - uncut[None]).abs().max()) < 1e-5
    # the port's layer on one card's share is that card's part and the shared expert
    held = {"router": lw["router"], "w_gate": lw["w_gate"][:8], "w_up": lw["w_up"][:8],
            "w_down": lw["w_down"][:8],
            "shared": {k: lw["shared_" + k[2:]] for k in ("w_gate", "w_up", "w_down")}}
    y, _ = L.moe(held, h, top_k=2, capacity_factor=0.0, score="sigmoid")
    assert float((y - parts[0] - shared).abs().max()) < 1e-6


def test_dropless_prefill_drops_no_held_token():
    """A capacity factor of 0 sizes the buffer to the busiest held expert:
    no assignment to a held expert is dropped, and a decode step's is 1."""
    torch.manual_seed(1)
    router, x = torch.randn(16, 16), torch.randn(2, 40, 16)
    buf, expert_of, pos, _, keep, _, _ = L._moe_dispatch(router, x, top_k=2, capacity_factor=0.0,
                                                         score="sigmoid", held=(0, 8))
    held = expert_of < 8
    counts = torch.stack([torch.bincount(expert_of[b][held[b]], minlength=8) for b in range(2)])
    assert buf.shape == (2, 8, int(counts.max()), 16)
    assert bool(keep[held].all())
    assert L._moe_dispatch(router, x[:, :1], top_k=2, capacity_factor=0.0,
                           held=(0, 8))[0].shape[2] == 1


def test_yarn_frequencies_and_interleaved_pairs():
    """YaRN's inverse frequencies at Mistral-Small-4's parameters against
    the closed form, and the rotation of interleaved pairs against complex
    multiplication."""
    pcfg = family.port_config(FULL, FULL["engine"])
    got = pcfg.rope_inv_freq().double()
    dim, base, factor, orig = 64, 10000.0, 128.0, 8192
    i = np.arange(dim // 2)
    plain = base ** (-2.0 * i / dim)
    wavelen_turns = orig * plain / (2 * np.pi)   # turns of each pair over the context
    lo = math.floor(dim * math.log(orig / (32 * 2 * math.pi)) / (2 * math.log(base)))
    hi = math.ceil(dim * math.log(orig / (1 * 2 * math.pi)) / (2 * math.log(base)))
    assert (lo, hi) == (12, 25)
    ramp = np.clip((i - lo) / (hi - lo), 0, 1)
    want = plain / factor * ramp + plain * (1 - ramp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (wavelen_turns[:lo] > 32).all() and (wavelen_turns[hi + 1:] < 1).all()
    assert pcfg.yarn.softmax_factor == pytest.approx((0.1 * math.log(128) + 1) ** 2)
    x = torch.randn(3, 2, 8, dtype=torch.float64)
    pos = torch.tensor([0, 5, 4000])
    inv = torch.tensor([1.0, 0.3, 0.01, 1e-4], dtype=torch.float64)
    out = L.apply_rope_interleaved(x, pos, inv)
    z = torch.view_as_complex(x.reshape(3, 2, 4, 2).contiguous())
    turn = torch.polar(torch.ones(3, 4, dtype=torch.float64), pos[:, None] * inv)[:, None]
    torch.testing.assert_close(out, torch.view_as_real(z * turn).reshape(3, 2, 8),
                               rtol=1e-6, atol=1e-6)


def test_store_writes_one_record_a_token(w, monkeypatch):
    """The accountant charges ``(kv_lora + rope) · 4`` bytes a token a layer
    for writes and reads, and the store, the reuse buffer and the slabs
    hold one plane: no V is written."""
    cfg = tiny()
    _, sess = serve(cfg, w, prompts_for(cfg), 9, monkeypatch)
    eng = sess.engine
    g, n_layers = 4, 2
    assert eng.store.entry_nbytes == RECORD * 4 and eng.store.group_nbytes == RECORD * 4 * g
    assert eng.store._mm.shape[3:] == (g, 1, 1, RECORD)
    assert eng.reuse[0].slots.shape[3:] == (1, 1, RECORD)
    assert eng.slabs.group_shape == (g, 1, 1, RECORD)
    groups = sum((37 + 9 - 1) // g + (50 + 9 - 1) // g for _ in range(n_layers))
    assert eng.accountant.write_bytes == groups * g * RECORD * 4
    assert eng.accountant.read_bytes % (g * RECORD * 4) == 0 and eng.accountant.read_bytes
    sess.close()
    assert family.kv_bytes_per_token(FULL) == 36 * 320 * 4 == 46_080


def test_expand_spans_and_counter(w, monkeypatch):
    """Each MLA layer's decompression is a span ``expand L{i}`` of phase
    ``gather``, and the counter counts the records decompressed."""
    cfg = tiny()
    obs = Observability()
    _, sess = serve(cfg, w, prompts_for(cfg), 5, monkeypatch, obs=obs)
    sess.close()
    spans = [s for s in obs.tracer.spans() if s.name.startswith("expand L")]
    steps = len(sess.engine.step_log)
    assert steps >= 4
    assert len(spans) == 2 * steps and {s.cat for s in spans} == {"gather"}
    per_layer = 2 * (3 * 4 + 4)                  # rows × (M·G + G)
    assert obs.registry.get("kvswap_latent_records_expanded_total").value == \
        steps * 2 * per_layer


def test_chunked_prefill_attention_equals_whole():
    torch.manual_seed(2)
    q, k = torch.randn(1, 45, 3, 16), torch.randn(1, 45, 3, 16)
    v = torch.randn(1, 45, 3, 8)
    torch.testing.assert_close(L.mla_causal_attention(q, k, v, chunk=8),
                               L.causal_attention(q, k, v), rtol=1e-5, atol=1e-6)


def test_tuner_counts_record_bytes():
    """The tuner prices an MLA layer's token as one 1,280-byte record, and
    its tuple at the benchmark's point is the configuration file's."""
    pcfg = family.port_config(FULL, FULL["engine"])
    dims = main_path.model_dims(pcfg)
    assert (dims.n_kv_heads, dims.head_dim, dims.kv_planes) == (1, 320, 1)
    inp = tuner.TunerInputs(dims=dims, n_layers=36, b_max=4, s_max=8192, budget_bytes=256 << 20)
    mem = tuner.memory_bytes(inp, sigma=1, g=4, m=100, c=16, b=1, s=8192)
    assert mem == 8192 * 320 * 2 * 36 + (16 + 1) * 4 * 320 * 2 * 36 + 100 * 4 * 320 * 2
    tuned, ecfg = main_path.tuned_engine_config(pcfg, b_max=4, s_max=8192,
                                                budget_bytes=256 << 20, disk="nvme")
    eng = FULL["engine"]
    assert (ecfg.group_size, ecfg.n_select, ecfg.rank, ecfg.reuse_capacity, ecfg.max_seq) == (
        eng["group_size"], eng["n_select"], eng["rank"], eng["reuse_capacity"], eng["max_seq"])


def test_published_widths_are_kept():
    """Every width of the configuration file is the published one; only the
    experts held (8 of 128) and the dtype are cut."""
    pcfg = family.port_config(FULL, FULL["engine"])
    assert (pcfg.n_layers, pcfg.d_model, pcfg.n_heads, pcfg.q_lora_rank, pcfg.kv_lora_rank,
            pcfg.qk_nope_head_dim, pcfg.qk_rope_head_dim, pcfg.v_head_dim) == (
        36, 4096, 32, 1024, 256, 64, 64, 128)
    assert (pcfg.n_experts, pcfg.moe_experts_held, pcfg.moe_top_k, pcfg.moe_d_ff,
            pcfg.moe_shared_d_ff, pcfg.vocab_size) == (128, 8, 4, 2048, 2048, 131072)
    assert FULL["reduced"] == ["n_routed_experts", "torch_dtype"]
    n = sum(math.prod(shape) for _, shape, std in family.leaves(FULL) if std is not None)
    assert n == pcfg.param_count() and 10.2e9 < n < 10.3e9     # the norm scales aside


class _Cache:   # stands in for a PrefixCache: the refusals come before any use
    cfg = None


@pytest.mark.parametrize("what", ["prefix_cache", "max_seq", "prefill_engine", "router",
                                  "device_path"])
def test_refusals(w, what):
    """What keeps K/V pairs refuses a latent-attention model up front: the
    prefix cache, the disaggregated prefill, the router and the full-cache
    device path (with its sequence-sharded attention); so does an engine
    whose ``max_seq`` passes the positions the model defines."""
    cfg = tiny()
    model, params, calib_k = build(cfg, w)
    ecfg = family.engine_config(cfg["engine"])
    with pytest.raises(ValueError):
        if what == "prefix_cache":
            ServeSession(model, params, ecfg, slots=1, calib_k=calib_k, prefix_cache=_Cache(),
                         device="cpu")
        elif what == "max_seq":
            KVSwapEngine(model, params, dataclasses.replace(ecfg, max_seq=256), batch=1,
                         calib_k=calib_k, device="cpu")
        elif what == "prefill_engine":
            from repro_torch.disagg.prefill import PrefillEngine

            PrefillEngine("p0", model, params, ecfg, cache=_Cache(), calib_k=calib_k,
                          device="cpu")
        elif what == "router":
            from repro_torch.router.pool import Replica

            sess = ServeSession(model, params, ecfg, slots=1, calib_k=calib_k, device="cpu")
            try:
                Replica("r0", sess)
            finally:
                sess.close()
        else:
            from repro_torch.serving import decode

            decode.init_cache(model.cfg, 1, 64, device="cpu")
