"""The port's warm tier (``repro_torch.tiers.WarmTier``) against the JAX
package's, and its engine-level contracts.

Port against reference: the same seeded stream of admits, serves,
invalidations, rewrites and row clears gives the same admits, hits,
evictions and payloads in both tiers (both are numpy, so exactly); an
engine with the tier on gives the reference engine's tokens, tier counters
and I/O accounting.  Inside the port: at ``kv_bits=8`` the tier changes the
bytes read, never the tokens; ``warm_budget_bytes=0`` leaves no tier
behind; ``metadata_bytes`` reports the tier; retiring a row frees its warm
bytes.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.tiers import WarmTier as JWarmTier
from repro_torch.bridge import params_from_numpy
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import ServeSession
from repro_torch.tiers import INDEX_ENTRY_BYTES, WarmTier

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128)
ENTRY = 4 * 2 * 2 * 16 + 4 + INDEX_ENTRY_BYTES        # one int8 group + scale + index
BUDGET = 1 << 20


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(21).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    prompt = np.random.default_rng(22).integers(0, tiny_cfg.vocab_size, (2, 57))
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib, prompt)


def engine(parts, batch=2, **kw):
    return KVSwapEngine(parts[2], parts[3], EngineConfig(**{**CFG, **kw}), batch=batch,
                        calib_k=parts[4], device="cpu")


@pytest.mark.parametrize("budget", [ENTRY, 3 * ENTRY + 17, 8 * ENTRY, BUDGET])
def test_tier_matches_reference_on_seeded_ops(budget):
    rng = np.random.default_rng(budget)
    tiers = (WarmTier(budget_bytes=budget), JWarmTier(budget_bytes=budget))
    for step in range(400):
        code, layer, row, gid = (int(rng.integers(0, n)) for n in (5, 2, 3, 6))
        kv = rng.integers(-100, 101, (4, 2, 2, 16)).astype(np.float32) * rng.random()
        if code <= 1:
            got = [t.admit(layer, row, gid, kv) for t in tiers]
        elif code == 2:
            got = [t.serve(layer, row, gid, np.float32) for t in tiers]
            assert (got[0] is None) == (got[1] is None), step
            got = [None if g is None else g.tobytes() for g in got]
        elif code == 3:
            got = [t.invalidate(layer, row, gid) for t in tiers]
        else:
            got = [t.clear_row(row) for t in tiers]
        assert got[0] == got[1], step
        assert tiers[0].bytes_used == tiers[1].bytes_used, step
    stats = [dataclasses.asdict(t.stats) for t in tiers]
    assert stats[0] == stats[1]
    assert stats[0]["admitted"] > 0 and stats[0]["hits"] > 0
    if budget < BUDGET:
        assert stats[0]["evicted"] > 0


def test_engine_tier_matches_reference(parts):
    """The same selections read the same groups, so the tier sees the same
    victims and hits: tokens, counters and I/O accounting equal."""
    kw = dict(CFG, kv_bits=8, warm_budget_bytes=BUDGET)
    with JEngine(parts[0], parts[1], JConfig(**kw), batch=2, calib_k=parts[4]) as je:
        want = je.generate(parts[5], 10)
        want_stats = dataclasses.asdict(je.warm.stats)
        want_snap = je.accountant.snapshot()
        want_meta = je.metadata_bytes()
    with engine(parts, kv_bits=8, warm_budget_bytes=BUDGET) as e:
        got = e.generate(parts[5], 10)
        assert dataclasses.asdict(e.warm.stats) == want_stats
        assert e.accountant.snapshot() == want_snap
        meta = e.metadata_bytes()
    np.testing.assert_array_equal(got, want)
    assert want_stats["hits"] > 0
    for key in ("warm_tier", "warm_tier_index", "warm_budget_bytes", "total"):
        assert meta[key] == want_meta[key]


@pytest.mark.parametrize("aio", [False, True], ids=["sync", "async"])
def test_kv8_tier_on_off_bit_identical(parts, aio):
    outs, reads = {}, {}
    for wb in (0, BUDGET):
        with engine(parts, kv_bits=8, async_io=aio, warm_budget_bytes=wb) as e:
            outs[wb] = e.generate(parts[5], 10)
            reads[wb] = e.accountant.snapshot()["read_bytes"]
            if wb:
                assert e.warm.stats.hits > 0, "the config never exercised the warm tier"
                assert sum(s.warm_bytes for s in e.step_log) == e.accountant.warm_bytes > 0
    np.testing.assert_array_equal(outs[0], outs[BUDGET])
    assert reads[BUDGET] < reads[0]


def test_disabled_tier_is_inert(parts):
    with engine(parts) as e:
        assert e.warm is None and e.store.warm is None
        assert all(m.warm is None for m in e.managers)
        e.generate(parts[5], 4)
        assert e.accountant.snapshot()["warm_bytes"] == 0
        assert "warm_tier" not in e.metadata_bytes()


def test_metadata_reports_budget_and_residency(parts):
    with engine(parts, kv_bits=8, warm_budget_bytes=BUDGET) as e:
        e.generate(parts[5], 8)
        meta = e.metadata_bytes()
        assert meta["warm_budget_bytes"] == BUDGET
        assert meta["warm_tier"] == e.warm.nbytes and meta["warm_tier_index"] == e.warm.index_nbytes
        assert 0 < meta["warm_tier"] + meta["warm_tier_index"] <= BUDGET
        assert meta["total"] >= meta["warm_tier"] + meta["reuse_buffer"]


def test_retire_row_frees_warm_bytes(parts):
    with engine(parts, kv_bits=8, warm_budget_bytes=BUDGET) as e:
        e.prefill(parts[5])
        for _ in range(8):
            e.decode_step(np.zeros(2, dtype=np.int64))
        assert e.warm.row_bytes(0) > 0 and e.warm.row_bytes(1) > 0
        e.retire_row(0)
        assert e.warm.row_bytes(0) == 0
        assert e.warm.row_bytes(1) > 0   # the neighbour keeps its entries


def test_session_tokens_match_and_report_warm(parts):
    """A session over a warm-tier engine gives the tier-off session's tokens
    and reports the tier's share from the accountant."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 97, n) for n in (41, 33, 37)]
    outs, stats = {}, {}
    for wb in (0, BUDGET):
        with ServeSession(parts[2], parts[3], EngineConfig(**CFG, kv_bits=8, warm_budget_bytes=wb),
                          slots=2, calib_k=parts[4], device="cpu") as sess:
            rids = [sess.submit(p, 8) for p in prompts]
            done = sess.drain()
            outs[wb] = [done[r].output for r in rids]
            stats[wb] = sess.stats()
    for a, b in zip(outs[0], outs[BUDGET]):
        np.testing.assert_array_equal(a, b)
    on = stats[BUDGET]
    assert stats[0]["warm_bytes"] == 0 and on["warm_bytes"] > 0
    assert on["warm_hit_rate"] == pytest.approx(on["warm_bytes"] / (on["warm_bytes"] + on["read_bytes"]))
    assert on["read_bytes"] < stats[0]["read_bytes"]
