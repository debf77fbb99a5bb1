"""The port's ``BatchServer`` (``repro_torch.serving.scheduler``) against
the JAX package's, on the reference's ``tiny_cfg`` weights through the
bridge and one calibration K.

Equal: the tokens of every request, ``real_requests`` and
``padded_requests``, and every modeled number of ``last_stats`` (the
throughput, the modeled I/O, compute and pipelined seconds, the
admissions' modeled seconds and the prefix-cache section), because the
port's selections and I/O accounting equal the reference's
(``test_torch_engine.py``).  Measured wall times differ and are left out.
Inside the port: one engine serves every flush, and a short flush masks
its empty slots instead of decoding clone rows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cache import PrefixCache as JCache, PrefixCacheConfig as JCacheConfig
from repro.core.engine import EngineConfig as JConfig
from repro.serving.scheduler import BatchServer as JBatchServer
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import BatchServer, ServeSession

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=12, max_seq=128,
           predict_from="self")
# modeled keys of last_stats (the rest are host wall times)
MODELED = ("reuse_ratio", "throughput", "batch_throughput", "real_requests",
           "padded_requests", "async_io", "io_seconds", "compute_seconds",
           "pipelined_seconds", "overlap_saved_seconds", "h2d_bytes", "active_rows")
PREFILL_MODELED = ("prompt_tokens", "cached_tokens", "computed_tokens", "restore_seconds",
                   "write_seconds", "compute_seconds", "modeled_seconds",
                   "modeled_cold_seconds")


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(21).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib)


def servers(parts, *, batch=2, jcache=None, cache=None, **kw):
    """The reference's and the port's servers on the same weights."""
    jm, jp, model, params, calib = parts
    return (JBatchServer(jm, jp, JConfig(**{**CFG, **kw}), batch=batch, calib_k=calib,
                         prefix_cache=jcache),
            BatchServer(model, params, EngineConfig(**{**CFG, **kw}), batch=batch,
                        calib_k=calib, prefix_cache=cache, device="cpu"))


def modeled(stats: dict) -> dict:
    out = {k: stats[k] for k in MODELED}
    out["prefill"] = {k: stats["prefill"][k] for k in PREFILL_MODELED}
    if "prefix_cache" in stats:
        out["prefix_cache"] = stats["prefix_cache"]
    return out


def drive(srv, flushes):
    """Submit each flush's ``(prompt, max_new)`` list, flushing what the
    batch size left queued; returns the tokens and each flush's stats."""
    rids, stats = [], []
    for reqs in flushes:
        rids += [srv.submit(p, n) for p, n in reqs]
        srv.flush()
        stats.append(modeled(srv.last_stats))
    return [srv.result(r) for r in rids], stats


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, n) for n in lens]


def test_flushes_match_reference(parts):
    """A full flush, then a padded one: tokens, real/padded counts and the
    modeled stats equal the reference's."""
    a, b, c = prompts(1, (24, 30, 20))
    flushes = [[(a, 5), (b, 5)], [(c, 3)]]
    jsrv, srv = servers(parts)
    with jsrv, srv:
        want = drive(jsrv, flushes)
        got = drive(srv, flushes)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    assert [(s["real_requests"], s["padded_requests"]) for s in got[1]] == [(2, 0), (1, 1)]


def test_warm_flush_matches_reference(parts):
    """With a prefix cache, the second flush restores the shared system
    prompt: its prefix-cache section (hit rate, saved tokens, published and
    resident blocks, the modeled speedup) equals the reference's."""
    head = prompts(2, (24,))[0]
    turn = lambda extra, seed: np.concatenate([head, prompts(seed, (extra,))[0]])
    flushes = [[(turn(6, 3), 4), (turn(6, 4), 4)], [(turn(8, 5), 4), (turn(8, 6), 4)]]
    with JCache(JCacheConfig(block_tokens=8)) as jc, \
            PrefixCache(PrefixCacheConfig(block_tokens=8)) as pc:
        jsrv, srv = servers(parts, jcache=jc, cache=pc)
        with jsrv, srv:
            want = drive(jsrv, flushes)
            got = drive(srv, flushes)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    assert got[1][0]["prefix_cache"]["hit_rate"] == 0.0
    assert got[1][1]["prefix_cache"]["hit_rate"] >= 0.5


def test_single_token_flush_matches_reference(parts):
    """``max_new = 1``: no decode step runs and the overlap keys stay at 0,
    as in the reference."""
    flushes = [[(p, 1) for p in prompts(7, (16, 20))]]
    jsrv, srv = servers(parts)
    with jsrv, srv:
        want = drive(jsrv, flushes)
        got = drive(srv, flushes)
        assert len(srv.session.engine.step_log) == 0
    assert got[1] == want[1] and got[1][0]["throughput"] == 0.0
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


def test_one_engine_across_flushes_and_session_tokens(parts):
    """Every flush runs on the server's one engine, and the tokens equal the
    same requests served by one ``ServeSession`` of as many slots."""
    _, _, model, params, calib = parts
    reqs = prompts(8, (24, 17, 30, 21, 26))
    with BatchServer(model, params, EngineConfig(**CFG), batch=2, calib_k=calib,
                     device="cpu") as srv:
        engine = srv.session.engine
        rids = [srv.submit(p, 4) for p in reqs]
        srv.flush()
        assert srv.session.engine is engine
        assert srv.last_stats["padded_requests"] == 1
        got = [srv.result(r) for r in rids]
        assert len(engine.admit_log) == 5
    with ServeSession(model, params, EngineConfig(**CFG), slots=2, calib_k=calib,
                      device="cpu") as sess:
        ids = [sess.submit(p, 4) for p in reqs]
        done = sess.drain()
    for g, r in zip(got, ids):
        np.testing.assert_array_equal(g, done[r].output)


def test_empty_slot_reads_nothing(parts):
    """A padded slot is a masked row: it selects no group and reads nothing."""
    _, _, model, params, calib = parts
    with BatchServer(model, params, EngineConfig(**CFG), batch=2, calib_k=calib,
                     device="cpu") as srv:
        read_rows = set()
        store = srv.session.engine.store
        gather = store.gather_groups

        def spy(layer, rows, gids, out):
            read_rows.update(rows.tolist())
            return gather(layer, rows, gids, out)

        store.gather_groups = spy
        srv.submit(prompts(9, (20,))[0], 3)
        srv.flush()
        assert (srv.last_stats["real_requests"], srv.last_stats["padded_requests"]) == (1, 1)
        assert read_rows == {0}


def test_async_io_matches_sync(parts):
    """``async_io`` on and off: the same tokens and modeled stats, as the
    reference's own ``TestBatchServerAsync`` requires."""
    _, _, model, params, calib = parts
    flushes = [[(p, 5) for p in prompts(10, (22, 28))]]
    runs = []
    for aio in (False, True):
        with BatchServer(model, params, EngineConfig(**CFG, async_io=aio), batch=2,
                         calib_k=calib, device="cpu") as srv:
            runs.append(drive(srv, flushes))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    strip = lambda s: {k: v for k, v in s.items() if k != "async_io"}
    assert [strip(s) for s in runs[0][1]] == [strip(s) for s in runs[1][1]]
    assert runs[1][1][0]["async_io"] is True


def test_device_and_adapter_pass_through(parts, monkeypatch):
    """``adapter=`` replaces ``calib_k``; ``device=None`` means the card and
    raises on a host without one (no fallback to the CPU)."""
    _, _, model, params, calib = parts
    from repro_torch.core.lowrank import fit_adapter

    adapter = fit_adapter(calib, rank=CFG["rank"], device="cpu")
    with BatchServer(model, params, EngineConfig(**CFG), batch=2, adapter=adapter,
                     device="cpu") as srv:
        assert srv.session.engine.adapter is adapter
        assert srv.session.engine.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(model, params, EngineConfig(**CFG), batch=2, calib_k=calib)
