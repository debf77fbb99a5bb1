"""The port's fault injection (``repro_torch.faults``) against the JAX
package's, and the recovery it exercises in the port's engine, prefix cache
and serving session.

Port against reference: the same ``FaultSpec`` injects the same faults
(decisions are a hash of the seed and the operation, so they do not depend
on the schedule), and an engine under faults gives the reference engine's
tokens, retries and injection counts.  Inside the port: transient faults
leave tokens bit-identical; persistent faults fail requests, not the
session; corruption at rest is quarantined and a warm prefill then equals
cold; the manifest recovers from a torn write, and a failed save does not
fail a drain.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.faults import FaultPlan as JPlan, FaultSpec as JSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.cache import PrefixCache, PrefixCacheConfig
from repro_torch.cache.manifest import Manifest
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.offload import DISKS, IOAccountant, KVDiskStore
from repro_torch.faults import FaultPlan, FaultSpec, FaultyDisk
from repro_torch.faults.errors import CorruptBlockError, InjectedCrash, ManifestCorrupt, MediaError
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.serving import ServeSession

CFG = dict(group_size=4, n_select=6, rank=8, reuse_capacity=12, max_seq=128,
           predict_from="self")
GEO = dict(n_layers=2, group_size=4, n_kv_heads=2, head_dim=8, dtype="float32")
TRANSIENT = dict(seed=3, read_error_rate=0.25, torn_read_rate=0.15, error_burst=1)


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(31).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib)


def engine(parts, batch=2, faults=None, **kw):
    return KVSwapEngine(parts[2], parts[3], EngineConfig(**{**CFG, **kw}), batch=batch,
                        calib_k=parts[4], faults=faults, device="cpu")


def session(parts, slots=2, faults=None, prefix_cache=None, **kw):
    return ServeSession(parts[2], parts[3], EngineConfig(**{**CFG, **kw}), slots=slots,
                        calib_k=parts[4], faults=faults, prefix_cache=prefix_cache,
                        device="cpu")


def serve(sess, prompts, max_new=4):
    rids = [sess.submit(p, max_new=max_new, arrival=0.05 * i) for i, p in enumerate(prompts)]
    sess.drain()
    return rids


def probe(plan, n=48):
    """Outcome of a fixed grid of reads and writes: a fault's class name or
    the modeled stall."""
    out = []
    for i in range(n):
        if i % 5 == 4:
            plan.on_write(i % 2, i % 3, 4 * i, 4)
        try:
            out.append(plan.on_read(i % 2, i % 3, 4 * (i - i % 5), 4, disk="emmc"))
        except Exception as exc:  # noqa: BLE001 — recording, not handling
            out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("spec", [
    dict(seed=7, read_error_rate=0.3, torn_read_rate=0.2, spike_rate=0.3, spike_seconds=0.004),
    dict(seed=11, bad_extent_rate=0.35, error_burst=2, read_error_rate=0.1),
], ids=["transient", "persistent"])
def test_same_spec_same_faults_as_reference(spec):
    ours, ref = FaultPlan(FaultSpec(**spec)), JPlan(JSpec(**spec))
    got, want = probe(ours), probe(ref)
    assert got == want
    assert len(set(map(str, got))) > 1                 # the campaign is live
    assert ours.snapshot() == ref.snapshot()
    assert ours.bad_extents() == ref.bad_extents()


def test_faulty_disk_shim():
    acc = IOAccountant(DISKS["emmc"])
    store = KVDiskStore(n_layers=2, batch=1, max_groups=8, group_size=4, n_kv_heads=2,
                        head_dim=8, accountant=acc)
    k = np.random.default_rng(0).standard_normal((2, 32, 2, 8)).astype(np.float32)
    for j in range(2):
        store.write_prefill_row(j, 0, k[j], k[j])
    fd = FaultyDisk(store, FaultPlan(FaultSpec(seed=0, spike_rate=1.0, spike_seconds=0.004)))
    got = fd.read_run(1, 0, 2, 3)
    for a, b in zip(got, store.read_run(1, 0, 2, 3)):
        np.testing.assert_array_equal(a, b)
    assert acc.snapshot()["stall_seconds"] == pytest.approx(0.004)
    assert fd.group_nbytes == store.group_nbytes
    fd.warm = None                       # the engine sets the tier on the proxy
    assert store.warm is None
    plan = FaultPlan(FaultSpec(seed=3, bad_extent_rate=1.0))
    fd = FaultyDisk(store, plan)
    fd.write_prefill_row(0, 0, k[0], k[0])
    (layer, row, gid), = plan.bad_extents()
    with pytest.raises(MediaError):
        fd.read_run(layer, row, gid, 1)


def test_engine_under_faults_matches_reference(parts):
    prompt = np.random.default_rng(32).integers(0, 97, (2, 30))
    with JEngine(parts[0], parts[1], JConfig(**CFG), batch=2, calib_k=parts[4],
                 faults=JPlan(JSpec(**TRANSIENT))) as je:
        want = je.generate(prompt, 8)
        want_retries = [m.retries for m in je.managers]
        want_faults = je.faults.snapshot()
    with engine(parts, faults=FaultPlan(FaultSpec(**TRANSIENT))) as e:
        assert isinstance(e.store, FaultyDisk)
        got = e.generate(prompt, 8)
        assert [m.retries for m in e.managers] == want_retries
        assert e.faults.snapshot() == want_faults
    np.testing.assert_array_equal(got, want)
    assert sum(want_retries) > 0


def test_transient_faults_leave_tokens_bit_identical(parts):
    prompts = [np.random.default_rng(33 + i).integers(0, 97, 24) for i in range(3)]
    with session(parts, async_io=True) as base:
        ref = [base.completed[r].output.tolist() for r in serve(base, prompts)]
    plan = FaultPlan(FaultSpec(**TRANSIENT))
    with session(parts, async_io=True, faults=plan) as sess:
        rids = serve(sess, prompts)
        stats = sess.stats()
        assert stats["io_retries"] > 0 and stats["failed_requests"] == 0
        assert sess.engine.prefetcher.deaths == 0
        assert [sess.completed[r].output.tolist() for r in rids] == ref


def test_persistent_faults_fail_requests_not_session(parts):
    prompts = [np.random.default_rng(36 + i).integers(0, 97, 24) for i in range(3)]
    with session(parts) as base:
        ref = [base.completed[r].output.tolist() for r in serve(base, prompts)]
    with session(parts, faults=FaultPlan(FaultSpec(seed=11, bad_extent_rate=0.35))) as sess:
        rids = serve(sess, prompts)              # must not raise
        stats = sess.stats()
    assert stats["failed_requests"] > 0
    assert stats["failed_requests"] + stats["completed_requests"] == len(rids)
    for i, rid in enumerate(rids):
        if rid in sess.completed:
            assert sess.completed[rid].output.tolist() == ref[i]
        else:
            assert sess.failed[rid].error


def test_corruption_quarantined_then_warm_equals_cold(parts):
    """A middle block corrupted at rest: the restore quarantines it and its
    descendants, the warm prefill truncates at the last verified block and
    still equals the cold prefill bit for bit."""
    prompt = np.random.default_rng(39).integers(0, 97, (2, 37)).astype(np.int32)
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache:
        with engine(parts) as cold:
            lc = cold.prefill(prompt)
            cold.publish(cache)
            cold_steps = [cold.decode_step(np.full(2, t)) for t in (5, 9)]
        n0 = cache.resident_blocks()
        chain = cache.match(prompt[0], max_tokens=36)
        cache.store._mm[1, chain[2].start_group + 1, 0, 1, 0, 3] += 1
        cache.pin(chain)
        with pytest.raises(CorruptBlockError) as err:
            cache.read_chain(chain)
        cache.unpin(chain)
        assert err.value.verified_blocks == 2
        assert cache.resident_blocks() == n0 - 2       # block 2 and its child
        with engine(parts) as warm:
            lw = warm.prefill_cached(prompt, cache)
            assert warm.prefill_report["cached_tokens"] == 16
            warm_steps = [warm.decode_step(np.full(2, t)) for t in (5, 9)]
        assert cache.stats.corrupt_blocks == 1 and cache.stats.quarantined_blocks == 2
    assert torch.equal(lc, lw)
    for a, b in zip(cold_steps, warm_steps):
        assert torch.equal(a, b)


def test_injected_corruption_is_never_served(parts):
    """Every block corrupted at publish: the session's warm admissions fall
    back to cold, quarantine what they find and keep the tokens."""
    rng = np.random.default_rng(40)
    head = rng.integers(0, 97, 24)
    reqs = [np.concatenate([head, rng.integers(0, 97, n)]) for n in (9, 13, 6, 11)]
    with session(parts) as base:
        ref = [base.completed[r].output.tolist() for r in serve(base, reqs, 5)]
    with PrefixCache(PrefixCacheConfig(block_tokens=8)) as cache:
        cache.use_faults(FaultPlan(FaultSpec(seed=0, corrupt_block_rate=1.0)))
        with session(parts, prefix_cache=cache) as sess:
            rids = serve(sess, reqs, 5)
            assert [sess.completed[r].cached_tokens for r in rids] == [0] * 4
            assert [sess.completed[r].output.tolist() for r in rids] == ref
        assert cache.stats.corrupt_blocks > 0 and cache.stats.quarantined_blocks > 0


def test_manifest_recovers_from_torn_write(tmp_path):
    d = str(tmp_path / "cache")
    cache = PrefixCache(PrefixCacheConfig(block_tokens=8, dir=d))
    cache.open(**GEO)
    cache.use_faults(FaultPlan(FaultSpec(crash_points=("manifest_write",))))
    with pytest.raises(InjectedCrash):
        cache.save()
    with pytest.raises(ManifestCorrupt):
        Manifest.load(os.path.join(d, "manifest.json"))
    with open(os.path.join(d, "blocks.bin"), "wb") as f:
        f.write(b"\0" * 4096)                  # an orphaned slab
    again = PrefixCache(PrefixCacheConfig(block_tokens=8, dir=d))
    assert again.recovered_from is not None
    assert not os.path.exists(os.path.join(d, "blocks.bin"))
    again.open(**GEO)
    again.save()
    assert PrefixCache(PrefixCacheConfig(block_tokens=8, dir=d)).recovered_from is None


def test_failed_manifest_save_does_not_fail_the_drain(parts, tmp_path):
    prompt = np.random.default_rng(41).integers(0, 97, 20)
    with PrefixCache(PrefixCacheConfig(block_tokens=8, dir=str(tmp_path / "c"))) as cache:
        plan = FaultPlan(FaultSpec(crash_points=("manifest_write",)))
        with session(parts, faults=plan, prefix_cache=cache) as sess:
            rid = sess.submit(prompt, 3)
            sess.drain()                           # the crash point fires here
            stats = sess.stats()
        assert len(sess.completed[rid].output) == 3
        assert stats["save_failures"] == 1 and stats["publish_failures"] == 0
        assert sess.published_blocks == 2
