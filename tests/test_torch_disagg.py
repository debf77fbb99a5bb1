"""The port's disaggregated prefill/decode (``repro_torch.disagg``) against
the JAX package's, and the reference's own disagg checks on the port.

Port against reference (``tiny_cfg`` weights through the bridge): the same
requests through both ``DisaggFrontEnd``s give the same tokens, ticket
states, attempts, modeled ready times and per-request records.  Inside the
port: tokens equal a solo co-located session's (a decode admission that
restores the chain and computes a suffix of two tokens or more gives
bit-equal first-token logits too; a one-token suffix takes the CPU's
matrix-vector route, whose bits differ, so there only the tokens are
held), the lockstep is deterministic, shedding is typed, and a chain
corrupted at rest between publish and handoff is quarantined and
re-prefilled without a decode row ever being admitted from it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.core.engine import EngineConfig as JConfig
from repro.disagg import DisaggFrontEnd as JFront, PrefillEngine as JPrefill
from repro.serving.api import ServeSession as JSession
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.disagg import (DONE, FAILED, READY, DisaggFrontEnd, PrefillEngine,
                                PrefillTicket)
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.main_path import run_disagg_path
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import ServeSession
from repro_torch.serving.errors import RequestRejected

BLOCK_TOKENS = 8
MAX_NEW = 6
CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=12, max_seq=128,
           predict_from="self")
# per-request keys that are modeled (the rest are host wall times)
RECORD_KEYS = ("rid", "arrival", "admitted_at", "first_token_at", "finished_at", "tokens",
               "prompt_tokens", "cached_tokens", "restored_tokens", "ttft_seconds",
               "tpot_seconds", "e2e_seconds", "prefill_engine", "decode", "prefill_attempts")


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    rng = np.random.default_rng(13)
    calib = rng.standard_normal((256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    prompts = [rng.integers(0, tiny_cfg.vocab_size, n) for n in (37, 29, 41)]
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib,
            prompts)


@pytest.fixture(scope="module")
def solo(parts):
    """Each request alone in a fresh one-slot session: its tokens and its
    cold first-token logits."""
    _, _, model, params, calib, prompts = parts
    out = []
    for p in prompts:
        with ServeSession(model, params, EngineConfig(**CFG), slots=1, calib_k=calib,
                          device="cpu") as sess:
            logits = []
            admit = sess.engine.admit_row
            sess.engine.admit_row = lambda *a: logits.append(admit(*a)) or logits[-1]
            rid = sess.submit(p, MAX_NEW)
            out.append((sess.drain()[rid].output, logits[0]))
    return out


def make_front(parts, cache, *, n_prefill=2, slots=2, **kw):
    _, _, model, params, calib, _ = parts
    prefills = [PrefillEngine(f"p{i}", model, params, EngineConfig(**CFG), cache=cache,
                              calib_k=calib, device="cpu") for i in range(n_prefill)]
    decode = ServeSession(model, params, EngineConfig(**CFG), slots=slots, calib_k=calib,
                          prefix_cache=cache, device="cpu")
    return DisaggFrontEnd(prefills, [decode], cache=cache, **kw)


def restored_floor(n_prompt: int) -> int:
    return ((n_prompt - 1) // BLOCK_TOKENS) * BLOCK_TOKENS


def drive(front, prompts):
    rids = [front.submit({"prompt": p, "max_new": MAX_NEW, "arrival": i * 1e-3})
            for i, p in enumerate(prompts)]
    out = front.drain()
    agg = front.aggregate({})
    tickets = [(front.tickets[r].state, front.tickets[r].attempts, front.tickets[r].ready_time,
                front.tickets[r].prefill_engine) for r in rids]
    recs = [{k: rec[k] for k in RECORD_KEYS} for rec in agg["per_request"]]
    return [out[r].tolist() for r in rids], tickets, recs, front.stats()


def run_front(parts, **kw):
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as cache, \
            make_front(parts, cache, **kw) as front:
        return drive(front, parts[5])


def test_handoff_matches_reference(parts):
    jm, jp, _, _, calib, prompts = parts
    got = run_front(parts)
    with JCache(JCacheConfig(block_tokens=BLOCK_TOKENS)) as jc:
        prefills = [JPrefill(f"p{i}", jm, jp, JConfig(**CFG), cache=jc, calib_k=calib)
                    for i in range(2)]
        decode = JSession(jm, jp, JConfig(**CFG), slots=2, calib_k=calib, prefix_cache=jc)
        with JFront(prefills, [decode], cache=jc) as jfront:
            want = drive(jfront, prompts)
    assert got[:3] == want[:3]
    keys = ("completed_requests", "prefill_published_blocks", "requeues", "ticket_failures",
            "makespan_s", "cached_prompt_tokens", "prefix_hit_rate")
    assert {k: got[3][k] for k in keys} == {k: want[3][k] for k in keys}
    assert [t[0] for t in got[1]] == [DONE] * 3


def test_tokens_equal_solo_and_logits_bit_equal_past_one_token(parts, solo):
    """Tokens equal each request's solo run; the decode admission's
    first-token logits are bit-equal to the solo cold prefill's where the
    restored chain leaves two tokens or more to compute."""
    _, _, _, _, _, prompts = parts
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as cache, \
            make_front(parts, cache) as front:
        logits = []
        eng = front.decodes[0].engine
        admit = eng.admit_row
        eng.admit_row = lambda *a: logits.append(admit(*a)) or logits[-1]
        tokens, _, recs, stats = drive(front, prompts)
    assert stats["prefill_published_blocks"] > 0 and stats["prefix_hit_rate"] > 0
    for p, toks, rec, lg, (want, cold) in zip(prompts, tokens, recs, logits, solo):
        assert toks == want.tolist()
        assert rec["restored_tokens"] == restored_floor(len(p)) and rec["prefill_attempts"] == 1
        if len(p) - rec["restored_tokens"] >= 2:
            assert torch.equal(lg, cold), len(p)
        else:
            torch.testing.assert_close(lg, cold, rtol=0, atol=1e-5)


def test_lockstep_is_deterministic(parts):
    assert run_front(parts)[:3] == run_front(parts)[:3]


def test_ticket_lifecycle_lands_done(parts):
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c, \
            make_front(parts, c) as front:
        rid = front.submit({"prompt": parts[5][0], "max_new": MAX_NEW})
        front.drain()
        front.result(rid)
        t = front.tickets[rid]
        assert t.state == DONE and t.chain_head is not None
        assert t.ready_time is not None and t.decode_rid is not None


def test_capacity_rejection_precedes_engines(parts):
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c, \
            make_front(parts, c) as front:
        with pytest.raises(RequestRejected) as ei:
            front.submit({"prompt": np.zeros(4096, np.int64), "max_new": MAX_NEW})
        assert ei.value.reason == "capacity" and not front.tickets
        assert all(not pe.has_work for pe in front.prefills)


def test_handoff_overload_sheds(parts):
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c, \
            make_front(parts, c, max_handoff_depth=1) as front:
        parked = PrefillTicket(rid=999, prompt=parts[5][0], max_new=1)
        parked.state = READY
        front.handoff.append(parked)
        with pytest.raises(RequestRejected) as ei:
            front.submit({"prompt": parts[5][1], "max_new": MAX_NEW})
        assert ei.value.reason == "handoff_overload" and front.handoff_rejections == 1
        front.handoff.clear()


def test_corrupt_chain_requeues_then_completes(parts, solo):
    """Every block corrupted at rest as it is published: the handoff finds
    the chain corrupt, quarantines it and re-queues the ticket before any
    decode row sees it; with the plan detached the re-prefill completes
    with the solo tokens, and the decode admission restores the clean
    chain."""
    prompt, (ref, _) = parts[5][0], solo[0]
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c:
        c.use_faults(FaultPlan(FaultSpec(seed=0, corrupt_block_rate=1.0)))
        with make_front(parts, c, n_prefill=1, slots=1) as front:
            rid = front.submit({"prompt": prompt, "max_new": MAX_NEW})
            while front.requeues == 0 and front.has_work:
                front.step()
            ticket = front.tickets[rid]
            assert front.requeues == 1 and ticket.attempts == 1 and ticket.decode_rid is None
            assert c.stats.corrupt_blocks >= 1 and c.stats.quarantined_blocks >= 1
            assert front.decodes[0].active_rows == 0 and front.decodes[0].queue_depth == 0
            c.use_faults(None)
            out = front.drain()
            np.testing.assert_array_equal(out[rid], ref)
            assert ticket.state == DONE and ticket.attempts == 2 and front.ticket_failures == 0
            rec = front.aggregate({})["per_request"][0]
            assert rec["prefill_attempts"] == 2
            assert rec["restored_tokens"] == restored_floor(len(prompt))


def test_persistent_corruption_fails_terminally(parts):
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c:
        c.use_faults(FaultPlan(FaultSpec(seed=0, corrupt_block_rate=1.0)))
        with make_front(parts, c, n_prefill=1, slots=1, max_prefill_attempts=2) as front:
            rid = front.submit({"prompt": parts[5][0], "max_new": MAX_NEW})
            assert front.drain() == {}
            ticket = front.tickets[rid]
            assert ticket.state == FAILED and ticket.attempts == 2 and "corrupt" in ticket.error
            assert (front.requeues, front.ticket_failures) == (1, 1)
            assert ticket.decode_rid is None
            assert front.decodes[0].stats()["completed_requests"] == 0


def test_prefill_engine_is_attention_only_and_needs_a_device(parts, monkeypatch):
    _, _, model, params, calib, _ = parts
    hybrid = TransformerAdapter(ModelConfig(
        name="hyb", arch_type="hybrid", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=61, block_pattern=("mamba2", "shared_attn", "mamba2")))
    with PrefixCache(PrefixCacheConfig(block_tokens=BLOCK_TOKENS)) as c:
        with pytest.raises(ValueError, match="attention-only"):
            PrefillEngine("p", hybrid, params, EngineConfig(**CFG), cache=c, calib_k=calib,
                          device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PrefillEngine("p", model, params, EngineConfig(**CFG), cache=c, calib_k=calib)


def test_disagg_path_on_cpu(tiny_cfg):
    """The chip run's disagg path, rehearsed on a narrow stand-in: every
    ticket done, each decode admission restores every published block below
    the prompt's last token, the
    prefill engine launches nothing, the tokens equal the co-located
    control's; then with 5 % of blocks corrupted at rest until the first
    re-queue."""
    cfg = ModelConfig(**dataclasses.asdict(tiny_cfg))
    kw = dict(device="cpu", engine_cfg=EngineConfig(**CFG), prompt_len=(30, 70), max_new=4,
              block_tokens=8, budget_bytes=64 << 20)
    run = run_disagg_path(cfg, **kw)
    assert run["states"] == [DONE] * 4 and all(run["tokens_equal"]) and run["logits_finite"]
    for n, t in zip(run["prompt_lens"], run["tickets"]):
        # every published block below the prompt's last token (which a
        # restore always leaves to compute)
        assert t["decode_admission"]["cached_tokens"] == (n - 1) // 8 * 8
        assert t["published_blocks"] == n // 8
    assert run["launches"] == run["prefill_launches"] == {"lowrank_group_scores": 0,
                                                          "gather_attention": 0}
    for f in run["first_logits"]:
        assert f["max_abs_diff"] <= 1e-5 * f["max_abs_logit"]
    bad = run_disagg_path(cfg, cache_faults=FaultPlan(FaultSpec(seed=0, corrupt_block_rate=0.05)),
                          **kw)
    rq = bad["requeued"]
    assert rq["rids"] and not any(rq["decode_admitted"])
    assert rq["cache_stats"]["quarantined_blocks"] > 0
    assert bad["states"] == [DONE] * 4 and all(bad["tokens_equal"])
    assert [bad["attempts"][r] for r in rq["rids"]] == [2] * len(rq["rids"])
