"""The port's multi-replica front end (``repro_torch.router``) against the
JAX package's, and the reference's own router checks on the port.

Port against reference (``tiny_cfg`` weights through the bridge, one
calibration K): one mixed-tenant trace through the reference ``FrontEnd``
over reference sessions and through the port's over port sessions gives
the same route for every request, the same tokens and the same modeled
fleet numbers (makespan, cached prompt tokens, per-request lifecycle),
under each of the three policies.  Then the reference's checks, on port
sessions: the pool's lifecycle, the policies, typed shedding, routed
tokens bit-identical to solo sessions, scoring that leaves every cache
untouched, fleet stats; and a CPU rehearsal of ``run_router_path``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.core.engine import EngineConfig as JConfig
from repro.router import FrontEnd as JFrontEnd, ReplicaPool as JPool
from repro.router import policy as jpolicy
from repro.serving.api import ServeSession as JSession
from repro.serving.metrics import SLOClass as JSLOClass
from repro.serving.trace import mixed_tenant_trace as jmixed
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.main_path import run_router_path
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.obs import Observability
from repro_torch.router import (DRAINING, LIVE, QUIESCED, FrontEnd, LeastLoaded,
                                PrefixAffinityRouter, ReplicaPool, RoundRobin)
from repro_torch.router import policy as tpolicy
from repro_torch.serving import SamplingParams, ServeSession
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.metrics import SLOClass
from repro_torch.serving.trace import mixed_tenant_trace

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=12, max_seq=128,
           predict_from="self")
SLO = {"interactive": SLOClass("interactive", ttft_s=5.0, tpot_s=5.0)}
JSLO = {"interactive": JSLOClass("interactive", ttft_s=5.0, tpot_s=5.0)}
# per-request keys that are modeled (the rest are host wall times)
RECORD_KEYS = ("rid", "replica", "tenant", "arrival", "admitted_at", "first_token_at",
               "finished_at", "tokens", "prompt_tokens", "cached_tokens", "ttft_seconds",
               "tpot_seconds", "e2e_seconds")
FLEET_KEYS = ("completed_requests", "completed_tokens", "routed_requests", "makespan_s",
              "prompt_tokens", "cached_prompt_tokens", "prefix_hit_rate",
              "goodput_tokens_per_s")


@pytest.fixture(scope="module")
def setup(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(11).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib)


def make_session(setup, *, slots=2, cache=True, obs=None):
    _, _, model, params, calib = setup
    pc = PrefixCache(PrefixCacheConfig(block_tokens=8)) if cache else None
    return ServeSession(model, params, EngineConfig(**CFG), slots=slots, calib_k=calib,
                        prefix_cache=pc, obs=obs, device="cpu")


def fleet(setup, n=3, policy=None, cache=True, **fe_kw):
    pool = ReplicaPool()
    for i in range(n):
        pool.add(f"r{i}", make_session(setup, cache=cache))
    return FrontEnd(pool, policy or RoundRobin(), **fe_kw)


def ref_fleet(setup, policy, n=3):
    jm, jp, _, _, calib = setup
    pool = JPool()
    for i in range(n):
        pool.add(f"r{i}", JSession(jm, jp, JConfig(**CFG), slots=2, calib_k=calib,
                                   prefix_cache=JCache(JCacheConfig(block_tokens=8))))
    return JFrontEnd(pool, policy)


def req(prompt, max_new=3, **kw):
    return {"prompt": prompt, "max_new": max_new, **kw}


def tiny_mixed_trace(seed=7, slo=SLO, gen=mixed_tenant_trace):
    return gen(seed, tenants=3, turns=3, sys_tokens=16, user_tokens=8, max_new=4,
               slo_classes=slo, vocab_size=97)


def view(front, out) -> tuple:
    """What must equal between the port and the reference: routes, tokens,
    the modeled per-request records and fleet totals."""
    routes = [front.route_of(i) for i in range(len(out["per_request"]))]
    tokens = [front.result(i).tolist() for i in range(len(routes))]
    recs = [{k: r[k] for k in RECORD_KEYS} for r in out["per_request"]]
    return routes, tokens, recs, {k: out["fleet"][k] for k in FLEET_KEYS}


# --------------------------------------------------------------------------
# port against reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["RoundRobin", "LeastLoaded", "PrefixAffinityRouter"])
def test_trace_routes_and_tokens_match_reference(setup, name):
    with fleet(setup, policy=getattr(tpolicy, name)()) as front:
        got = view(front, front.replay(tiny_mixed_trace()))
    with ref_fleet(setup, getattr(jpolicy, name)()) as jfront:
        want = view(jfront, jfront.replay(tiny_mixed_trace(7, JSLO, jmixed)))
    assert got == want
    assert got[3]["completed_requests"] == 9


# --------------------------------------------------------------------------
# pool lifecycle
# --------------------------------------------------------------------------

class TestPoolLifecycle:
    def test_duplicate_name_raises(self, setup):
        pool = ReplicaPool()
        pool.add("r0", make_session(setup, cache=False))
        with pytest.raises(ValueError, match="duplicate"):
            pool.add("r0", None)
        pool.close()

    def test_drain_stops_routing(self, setup):
        with fleet(setup, n=2, cache=False) as front:
            front.pool.drain("r0")
            assert front.pool["r0"].state == DRAINING
            assert [r.name for r in front.pool.live()] == ["r1"]
            rids = [front.submit(req(np.arange(8))) for _ in range(4)]
            assert {front.route_of(r) for r in rids} == {"r1"}

    def test_quiesce_preconditions(self, setup):
        with fleet(setup, n=2, cache=False) as front:
            with pytest.raises(ValueError, match="must be draining"):
                front.pool.quiesce("r0")
            front.submit(req(np.arange(8)))
            front.pool.drain("r0")
            with pytest.raises(ValueError, match="still has work"):
                front.pool.quiesce("r0")

    def test_drain_leaves_no_stranded_requests(self, setup):
        with fleet(setup, n=3, cache=False) as front:
            rids = [front.submit(req(np.arange(6 + i), max_new=3)) for i in range(6)]
            front.pool.drain("r1")
            assert sorted(front.drain()) == rids
            r1 = front.pool["r1"]
            assert r1.state == QUIESCED and r1.final_stats["completed_requests"] == 2
            assert front.stats()["completed_requests"] == 6
            with pytest.raises(ValueError, match="quiesced"):
                front.pool.drain("r1")

    def test_all_drained_sheds_typed(self, setup):
        with fleet(setup, n=2, cache=False) as front:
            front.pool.drain("r0")
            front.pool.drain("r1")
            with pytest.raises(RequestRejected) as ei:
                front.submit(req(np.arange(8)))
            assert ei.value.reason == "no_live_replicas" and front.router_rejections == 1


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

class TestPolicies:
    def test_round_robin_cycles_in_pool_order(self, setup):
        with fleet(setup, n=3, cache=False) as front:
            rids = [front.submit(req(np.arange(8))) for _ in range(6)]
            assert [front.route_of(r) for r in rids] == ["r0", "r1", "r2"] * 2

    def test_least_loaded_balances(self, setup):
        with fleet(setup, n=2, policy=LeastLoaded(), cache=False) as front:
            rids = [front.submit(req(np.arange(8))) for _ in range(4)]
            assert [front.route_of(r) for r in rids] == ["r0", "r1", "r0", "r1"]

    def test_affinity_deterministic_and_sticky(self, setup):
        """Two identical fleets route the trace alike, and every tenant's
        turns stay on one replica."""
        routes = []
        tr = tiny_mixed_trace()
        for _ in range(2):
            with fleet(setup, policy=PrefixAffinityRouter()) as front:
                front.replay(tr)
                routes.append([front.route_of(i) for i in range(tr.n_requests)])
        assert routes[0] == routes[1]
        by_tenant: dict = {}
        for r, name in zip(tr.requests, routes[0]):
            by_tenant.setdefault(r.tenant, set()).add(name)
        assert all(len(names) == 1 for names in by_tenant.values()), by_tenant

    def test_affinity_overload_penalty_repels(self, setup):
        with fleet(setup, policy=PrefixAffinityRouter()) as front:
            prompt = np.arange(40)
            rid = front.submit(req(prompt, max_new=2))
            front.drain()
            warm = front.pool[front.route_of(rid)]
            pol = front.policy
            assert pol.score(warm, prompt) > max(pol.score(r, prompt)
                                                 for r in front.pool if r is not warm)
            warm.session._degrade_level = 1
            assert pol.score(warm, prompt) < 0.0
            assert max(front.pool, key=lambda r: pol.score(r, prompt)) is not warm

    def test_policy_arguments_checked(self):
        with pytest.raises(ValueError, match=">= 0"):
            PrefixAffinityRouter(load_weight=-1.0)
        assert repr(PrefixAffinityRouter()) == repr(jpolicy.PrefixAffinityRouter())


# --------------------------------------------------------------------------
# shedding
# --------------------------------------------------------------------------

class TestShedding:
    def test_router_overload_sheds_typed_without_touching_sessions(self, setup):
        with fleet(setup, n=2, cache=False, max_queue_depth=1) as front:
            for _ in range(2):
                front.submit(req(np.arange(8), arrival=100.0))
            with pytest.raises(RequestRejected) as ei:
                front.submit(req(np.arange(8), arrival=100.0))
            assert ei.value.reason == "router_overload" and ei.value.max_queue_depth == 1
            assert all(rep.session.rejected == 0 for rep in front.pool)
            assert front.stats()["router_rejections"] == 1

    def test_replica_rejection_propagates_with_name(self, setup):
        with fleet(setup, n=2, cache=False) as front:
            with pytest.raises(RequestRejected) as ei:
                front.submit(req(np.arange(200), max_new=50))
            assert ei.value.reason == "capacity" and ei.value.replica == "r0"
            assert front.pool["r0"].shed == 1

    def test_router_metrics_labeled_per_replica(self, setup):
        obs = Observability()
        with fleet(setup, n=2, cache=False, obs=obs) as front:
            for _ in range(3):
                front.submit(req(np.arange(8)))
            snap = obs.registry.snapshot()
        assert snap['kvswap_router_requests_total{replica="r0"}'] == 2
        assert snap['kvswap_router_requests_total{replica="r1"}'] == 1


# --------------------------------------------------------------------------
# routed == solo, scoring leaves caches alone, fleet stats
# --------------------------------------------------------------------------

def test_routed_tokens_bit_identical_to_solo_sessions(setup):
    tr = tiny_mixed_trace()
    with fleet(setup, policy=PrefixAffinityRouter()) as front:
        front.replay(tr)
        by_replica: dict = {}
        for i, r in enumerate(tr.requests):
            by_replica.setdefault(front.route_of(i), []).append((i, r))
        assert len(front.results()) == tr.n_requests
        for name, routed in by_replica.items():
            with make_session(setup) as solo:
                local = {rid: solo.submit(r.materialize(tr.vocab_size), r.max_new,
                                          arrival=r.arrival, slo_class=r.slo_class,
                                          tenant=r.tenant) for rid, r in routed}
                solo.drain()
                sess = front.pool[name].session
                for rid, _ in routed:
                    np.testing.assert_array_equal(front.result(rid),
                                                  solo.completed[local[rid]].output)
                    assert sess.completed[local[rid]].finished_at \
                        == solo.completed[local[rid]].finished_at


def test_sampled_requests_bit_identical(setup):
    prompt = np.arange(12)
    with fleet(setup, n=2, cache=False) as front:
        rid = front.submit(req(prompt, max_new=6, temperature=0.8, top_k=20, seed=42))
        front.drain()
        routed = front.result(rid)
    with make_session(setup, cache=False) as solo:
        lid = solo.submit(prompt, 6, sampling=SamplingParams(temperature=0.8, top_k=20, seed=42))
        solo.drain()
        np.testing.assert_array_equal(routed, solo.completed[lid].output)


def test_scoring_never_perturbs_replica_caches(setup):
    with fleet(setup, policy=PrefixAffinityRouter()) as front:
        for i in range(3):
            front.submit(req(np.arange(24) + i, max_new=2))
        front.drain()
        view_ = lambda c: (dataclasses.asdict(c.stats),
                           {b: (m.last_used, m.pins) for b, m in c.manifest.blocks.items()})
        before = [view_(rep.session.prefix_cache) for rep in front.pool]
        for _ in range(10):
            for rep in front.pool:
                front.policy.score(rep, np.arange(24))
        assert [view_(rep.session.prefix_cache) for rep in front.pool] == before


def test_stats_and_aggregate_consistent(setup):
    tr = tiny_mixed_trace()
    with fleet(setup, policy=PrefixAffinityRouter()) as front:
        out = front.replay(tr)
        st = out["fleet"]
        assert (st["policy"], st["n_replicas"]) == ("prefix_affinity", 3)
        assert st["completed_requests"] == st["routed_requests"] == tr.n_requests
        assert st["completed_requests"] == sum(p["session"]["completed_requests"]
                                               for p in st["replicas"].values())
        assert st["makespan_s"] == max(p["now"] for p in st["replicas"].values())
        assert 0.0 < st["prefix_hit_rate"] <= 1.0 and st["replicas"]["r0"]["state"] == LIVE
        recs = out["per_request"]
        assert [r["rid"] for r in recs] == list(range(tr.n_requests))
        assert all(r["replica"] in front.pool.names() for r in recs)
        assert out["makespan_seconds"] == st["makespan_s"]


def test_unknown_request_keys_raise(setup):
    with fleet(setup, n=1, cache=False) as front:
        with pytest.raises(ValueError, match="unknown request keys"):
            front.submit({"prompt": np.arange(4), "temprature": 1.0})
        with pytest.raises(ValueError, match="not both"):
            front.submit({"prompt": np.arange(4), "max_new": 2, "max_tokens": 2})


def test_router_path_on_cpu(tiny_cfg):
    """The chip run's router path, rehearsed on a narrow stand-in: later
    turns stay on their tenant's replica and restore their prefix, routed
    tokens equal solo sessions', scoring leaves the caches alone, and the
    CPU launches no kernel."""
    cfg = ModelConfig(**dataclasses.asdict(tiny_cfg))
    tr = mixed_tenant_trace(0, tenants=3, turns=3, sys_tokens=32, user_tokens=12, max_new=4,
                            turn_gap_s=1.0, slo_classes=SLO, vocab_size=97)
    run = run_router_path(cfg, device="cpu", engine_cfg=EngineConfig(**CFG), trace=tr,
                          block_tokens=8, budget_bytes=64 << 20, solo=True, peek=True)
    first = {q["tenant"]: q["replica"] for q in run["requests"] if q["turn"] == 1}
    for q in run["requests"]:
        assert len(q["output"]) == 4
        if q["turn"] > 1:
            assert q["replica"] == first[q["tenant"]]
            assert q["arrival"] >= q["prev_finished_at"]
            assert q["cached_tokens"] >= 32
    assert all(run["solo_equal"]) and run["peek_neutral"] and run["logits_finite"]
    assert run["launches"] == {"lowrank_group_scores": 0, "gather_attention": 0}
    assert run["fleet"]["prefix_hit_rate"] == pytest.approx(
        sum(q["cached_tokens"] for q in run["requests"])
        / sum(q["prompt_tokens"] for q in run["requests"]))
