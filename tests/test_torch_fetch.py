"""The port's fetch against the reference's ``KVCacheManager``.

``KVCacheManager.fetch`` takes one way for every tier chain: a row's misses
go to the warm tier (when attached), the residue is vetted by the store and
placed in the reuse buffer in one call, and the disk's groups of every row
are charged in one call and read with one gather, into the upload slab or a
host buffer.  Two managers over the same data, the port's and the JAX
package's (``repro.core.manager``), fed the same drifting selections, must
end each step equal: the mapping table (staged keys and bytes too), what the
slab delivers to the device mirror, the reuse buffer's state and host slots,
the warm tier's entries in LRU order, the accountant's snapshot, the
``kvswap_io_*``, ``kvswap_read_plan_*`` and ``kvswap_warm_*`` counters, and a
``FetchFailed`` with the state it leaves behind.  The latent (MLA) shape's
one-plane store, which the reference's store lacks, is read by the
reference's manager through the port's store.  Held besides: each batched
piece against the loop it replaces, and engines with a warm tier against the
reference's engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig, KVSwapEngine as JEngine
from repro.core.manager import KVCacheManager as JManager
from repro.core.offload import DISKS as JDISKS, IOAccountant as JAccountant, KVDiskStore as JStore
from repro.core.reuse_buffer import ReuseBuffer as JReuse
from repro.core.rolling_buffer import RollingBuffer as JRolling
from repro.faults import FaultPlan as JPlan, FaultSpec as JSpec, FaultyDisk as JFaultyDisk
from repro.faults import FetchFailed as JFetchFailed, RetryPolicy as JRetry
from repro.io.scheduler import ReadScheduler as JScheduler
from repro.obs import Observability as JObservability
from repro.tiers import WarmTier as JWarmTier
from repro_torch.bridge import params_from_numpy
from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.manager import KVCacheManager
from repro_torch.core.offload import DISKS, IOAccountant, KVDiskStore
from repro_torch.core.reuse_buffer import ReuseBuffer
from repro_torch.core.rolling_buffer import RollingBuffer
from repro_torch.core.upload import SlabRing
from repro_torch.faults import FaultPlan, FaultSpec, FaultyDisk
from repro_torch.faults.errors import FetchFailed
from repro_torch.faults.retry import RetryPolicy
from repro_torch.io.scheduler import ReadScheduler
from repro_torch.models.transformer import ModelConfig, TransformerAdapter
from repro_torch.obs import Observability
from repro_torch.obs.metrics import fold
from repro_torch.tiers import INDEX_ENTRY_BYTES, WarmTier

B, MAX_GROUPS, LAYER, STEPS = 3, 56, 1, 32
# the cells' shapes in small: G, planes, H_kv, d, reuse capacity C, selection
# M, int8 store, coalescing gap
SHAPES = {
    "granite": dict(g=4, planes=2, h=2, d=8, c=6, m=10, bits=0, gap=0),      # C < M: staged
    "granite-gap2": dict(g=4, planes=2, h=2, d=8, c=6, m=10, bits=0, gap=2),
    "mla": dict(g=3, planes=1, h=1, d=20, c=4, m=12, bits=0, gap=0),         # one plane
    "olmoe": dict(g=4, planes=2, h=2, d=8, c=20, m=6, bits=0, gap=0),        # C > M
    "int8": dict(g=4, planes=2, h=2, d=8, c=5, m=9, bits=8, gap=0),
}
WARM_ENTRY = 4 * 2 * 2 * 8 + 4 + INDEX_ENTRY_BYTES     # one int8 granite group in the warm tier
# the chains the per-group walk used to serve: (store bits, fault spec, warm tier?)
CHAINS = {
    "faulty-transient": (0, dict(seed=3, read_error_rate=0.25, torn_read_rate=0.15,
                                 error_burst=1, spike_rate=0.3), False),
    "faulty-bad-extent": (0, dict(seed=5, bad_extent_rate=0.6), False),
    "warm-16": (0, None, True),
    "warm-8": (8, None, True),
}


def raw(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def build(sh, data, *, port, slabs=False, faults=None, warm=False, disk="nvme"):
    """Layer ``LAYER``'s manager over its own store holding ``data``: the
    port's, or the reference's (over the port's store for one plane)."""
    g, p, h, d = sh["g"], sh["planes"], sh["h"], sh["d"]
    obs = Observability() if port else JObservability()
    acc = (IOAccountant if port else JAccountant)((DISKS if port else JDISKS)[disk])
    acc.bind_metrics(obs.registry)
    geo = dict(n_layers=2, batch=B, max_groups=MAX_GROUPS, group_size=g, n_kv_heads=h,
               head_dim=d, accountant=acc, quant_bits=sh["bits"])
    store = (KVDiskStore(**geo, planes=p) if port or p == 1 else JStore(**geo))
    if faults is not None:
        store = (FaultyDisk(store, FaultPlan(FaultSpec(**faults))) if port else
                 JFaultyDisk(store, JPlan(JSpec(**faults))))
    for bi, (k, v) in enumerate(data):
        store.write_prefill_row(LAYER, bi, k, v)
    tier = None
    if warm:
        tier = (WarmTier if port else JWarmTier)(budget_bytes=12 * WARM_ENTRY, accountant=acc,
                                                obs=obs)
        store.warm = tier
    if port:
        reuse = ReuseBuffer(batch=B, capacity=sh["c"], group_size=g, n_kv_heads=h, head_dim=d,
                            planes=p)
        ring = None
        if slabs:
            ring = SlabRing(1, batch=B, n_select=sh["m"], group_shape=(g, p, h, d),
                            dtype=np.float32, device="cpu", obs=obs)
            reuse.attach_device_mirror("cpu")
        mgr = KVCacheManager(store=store, reuse=reuse, layer=LAYER, obs=obs, slabs=ring, warm=tier,
                             rolling=RollingBuffer(batch=B, group_size=g, n_kv_heads=h,
                                                   head_dim=d, planes=p),
                             scheduler=ReadScheduler(sh["gap"]), retry=RetryPolicy())
    else:
        mgr = JManager(store=store, layer=LAYER, obs=obs, warm=tier,
                       reuse=JReuse(batch=B, capacity=sh["c"], group_size=g, n_kv_heads=h,
                                    head_dim=d),
                       rolling=JRolling(batch=B, group_size=g, n_kv_heads=h, head_dim=d),
                       scheduler=JScheduler(sh["gap"]), retry=JRetry())
    return mgr, obs


def documents(rng, sh, n_groups):
    return [tuple(rng.standard_normal((n * sh["g"] + 2, sh["h"], sh["d"])).astype(np.float32)
                  for _ in range(2)) for n in n_groups]


def selections(rng, m, n_groups):
    """Drifting top-M selections: about a quarter of a row's ids change a
    step (ids may repeat); now and then a short row (masked tail, id 0) and
    an idle row (all masked).  Every fourth step each row's next group
    lands (``n_groups`` grows)."""
    cur = [rng.choice(n, m, replace=False) for n in n_groups]
    for t in range(STEPS):
        ids, mask = np.zeros((B, m), np.int64), np.ones((B, m), bool)
        for bi, n in enumerate(n_groups):
            cur[bi] = np.where(rng.random(m) < 0.75, cur[bi], rng.choice(n, m, replace=False))
            ids[bi] = cur[bi]
        if t % 5 == 2:
            ids[1, m // 2:], mask[1, m // 2:] = 0, False
        if t % 7 == 3:
            ids[2], mask[2] = 0, False
        yield ids, mask


def counters(obs) -> dict:
    return {k: v for k, v in obs.registry.snapshot().items()
            if k.startswith(("kvswap_io_", "kvswap_read_plan_", "kvswap_warm_"))}


def assert_reuse_equal(port, ref, p=2):
    """The port's reuse buffer against the reference's, whose slots hold two
    planes (a one-plane record as both)."""
    np.testing.assert_array_equal(port.slot_table, ref.slot_table)
    assert port._index == ref._index and port._free == ref._free
    assert [list(f) for f in port._fifo] == [list(f) for f in ref._fifo]
    assert (port.stats.hits, port.stats.misses) == (ref.stats.hits, ref.stats.misses)
    np.testing.assert_array_equal(raw(port.slots), raw(ref.slots[:, :, :, :p]))


def assert_warm_equal(port, ref):
    if ref is None:
        return
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.bytes_used == ref.bytes_used and list(port._entries) == list(ref._entries)
    for a, b in zip(port._entries.values(), ref._entries.values()):
        assert (a.scale, a.charged, a.disk_nbytes) == (b.scale, b.charged, b.disk_nbytes)
        np.testing.assert_array_equal(a.q, b.q)


def assert_states_equal(a, oa, r, orf, p):
    assert_reuse_equal(a.reuse, r.reuse, p)
    assert_warm_equal(a.warm, r.warm)
    assert a.store.accountant.snapshot() == r.store.accountant.snapshot()
    assert counters(oa) == counters(orf)
    assert (a.retries, a.fetch_failures) == (r.retries, r.fetch_failures)


def assert_tables_equal(ta, tr, p):
    for f in ("group_ids", "slots", "group_mask", "rolling_fill"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tr, f))
    assert list(ta.staged) == list(tr.staged)
    for key, kv in ta.staged.items():
        np.testing.assert_array_equal(raw(kv), raw(tr.staged[key][:, :p]))


def assert_delivered(a, ta, tr, p):
    """The slab's index block and payload, delivered: the table's addressing,
    the mirror equal to the reference's host slots wherever a group is
    resident, and the staged groups at their context positions."""
    up, _ = a.sync_device(ta)
    np.testing.assert_array_equal(up.slots.numpy(), tr.slots)
    np.testing.assert_array_equal(up.fill.numpy(), tr.rolling_fill)
    held = a.reuse.slot_table >= 0
    mirror = a.reuse.device
    for i, plane in enumerate((mirror.k, mirror.v)[:p]):
        np.testing.assert_array_equal(raw(plane.numpy()[held]), raw(a.reuse.slots[:, :, :, i][held]))
    b, m = tr.slots.shape
    g, shape = a.reuse.group_size, a.reuse.slots.shape[4:]
    got, want = (torch.zeros((2, b, m * g) + shape) for _ in range(2))
    up.put_staged(got[0], got[1])
    for bi, mi in zip(*np.nonzero(tr.slots == -2)):
        kv = torch.from_numpy(tr.staged[(int(bi), int(tr.group_ids[bi, mi]))])
        want[:, bi, mi * g:(mi + 1) * g] = kv.permute(1, 0, 2, 3)[[0, p - 1]]
    if p == 1:
        want[1] = 0
    assert torch.equal(got, want)


def drive(sh, rng, n_groups, a, oa, r, orf, *, slabs):
    """Feed both managers the same selections; compare after every step.
    Returns the groups served, staged and the fetches that failed."""
    p = sh["planes"]
    served = staged = failed = 0
    for t, (ids, mask) in enumerate(selections(rng, sh["m"], n_groups)):
        misses0 = r.reuse.stats.misses
        try:
            tr = r.fetch(ids, mask)
        except JFetchFailed as exc:
            with pytest.raises(FetchFailed) as got:
                a.fetch(ids, mask)
            assert (got.value.layer, got.value.row, got.value.start, got.value.count) == (
                exc.layer, exc.row, exc.start, exc.count)
            assert_states_equal(a, oa, r, orf, p)
            failed += 1
            for bi in range(B):     # the session retires every running row
                a.reuse.clear_row(bi)
                r.reuse.clear_row(bi)
            continue
        ta = a.fetch(ids, mask)
        served += r.reuse.stats.misses - misses0
        staged += len(tr.staged)
        assert_tables_equal(ta, tr, p)
        if slabs:
            assert_delivered(a, ta, tr, p)
        else:
            for x, y in zip(a.gather(ta), r.gather(tr)):
                np.testing.assert_array_equal(raw(x), raw(y))
        assert_states_equal(a, oa, r, orf, p)
        if t % 4 == 3:   # each row's next group lands on both stores
            for bi in range(B):
                k, v = rng.standard_normal((2, sh["g"], sh["h"], sh["d"])).astype(np.float32)
                a.store.append_group_row(LAYER, bi, k, v)
                r.store.append_group_row(LAYER, bi, k, v)
            n_groups[:] = [n + 1 for n in n_groups]
    return served, staged, failed


@pytest.mark.parametrize("slabs", [True, False], ids=["slab", "host"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fetch_equals_the_reference(shape, slabs):
    sh = SHAPES[shape]
    rng = np.random.default_rng(7)
    n_groups = [40, 44, 36]
    data = documents(rng, sh, n_groups)
    (a, oa), (r, orf) = (build(sh, data, port=port, slabs=slabs) for port in (True, False))
    served, staged, _ = drive(sh, rng, n_groups, a, oa, r, orf, slabs=slabs)
    snap = oa.registry.snapshot()
    assert served > 0 and (staged > 0) == (sh["c"] < sh["m"])
    assert a.disk.retries == 0 and snap["kvswap_read_plan_groups_read_total"] >= served
    if slabs:
        assert a.slabs.n_free == 1


@pytest.mark.parametrize("chain", list(CHAINS))
def test_every_chain_takes_the_one_path(chain):
    """The chains the per-group walk served before, a ``FaultyDisk`` (its
    transient faults retried, GC stalls charged; or grown bad extents that
    raise ``FetchFailed``) or a warm tier over a raw or an int8 store, on the
    device path against the reference's manager."""
    bits, faults, warm = CHAINS[chain]
    sh = dict(SHAPES["granite"], bits=bits)
    rng = np.random.default_rng(11)
    n_groups = [40, 44, 36]
    data = documents(rng, sh, n_groups)
    (a, oa), (r, orf) = (build(sh, data, port=port, slabs=True, faults=faults, warm=warm,
                               disk="emmc") for port in (True, False))
    served, _, failed = drive(sh, rng, n_groups, a, oa, r, orf, slabs=True)
    snap = oa.registry.snapshot()
    assert served > 0 and a.slabs.n_free == 1
    if chain == "faulty-transient":
        assert a.retries > 0 and snap["kvswap_io_stall_seconds_total"] > 0 and not failed
    if chain == "faulty-bad-extent":
        assert 0 < failed < STEPS and a.fetch_failures == failed
    if warm:
        assert a.warm.stats.hits > 0 and a.warm.stats.evicted > 0


def test_place_equals_the_insert_loop():
    """``ReuseBuffer.place`` then one indexed write leaves what the
    reference's ``insert`` on each group in turn leaves: free slots in pop
    order, unprotected residents evicted in FIFO order (the victim sink
    called for each, in that order, with the bytes the slot held), the rest
    without a slot."""
    g, h, d, c = 2, 1, 3, 5
    for seed in range(40):
        rng = np.random.default_rng(seed)
        loop = JReuse(batch=2, capacity=c, group_size=g, n_kv_heads=h, head_dim=d)
        batch = ReuseBuffer(batch=2, capacity=c, group_size=g, n_kv_heads=h, head_dim=d)
        sunk = {id(loop): [], id(batch): []}
        for buf in (loop, batch):
            buf.victim_sink = lambda bi, gid, kv, _to=sunk[id(buf)]: _to.append(
                (bi, gid, kv.copy()))
        for _ in range(12):
            bi = int(rng.integers(2))
            want = [int(x) for x in rng.choice(30, int(rng.integers(1, 9)), replace=False)]
            hits, misses = loop.lookup(bi, want)
            assert (hits, misses) == batch.lookup(bi, want)
            gids = np.array(misses, np.int64)[rng.permutation(len(misses))]
            kv = rng.standard_normal((gids.size, g, 2, h, d)).astype(np.float32)
            got = [loop.insert(bi, int(x), kv[i], protected=set(want)) for i, x in
                   enumerate(gids.tolist())]
            at = batch.place(bi, gids, set(want))
            batch.slots[bi, at[at >= 0]] = kv[at >= 0]
            assert at.tolist() == [-1 if s is None else s for s in got]
            assert_reuse_equal(batch, loop)
        a, b = sunk[id(loop)], sunk[id(batch)]
        assert [(r, x) for r, x, _ in a] == [(r, x) for r, x, _ in b]
        assert all(np.array_equal(raw(x), raw(y)) for (_, _, x), (_, _, y) in zip(a, b))
    assert any(sunk.values())


def test_run_lengths_equal_the_plan():
    """The numpy run planner gives ``plan``'s run lengths, at each gap."""
    rng = np.random.default_rng(1)
    for gap in (0, 1, 3):
        sched = ReadScheduler(gap)
        for _ in range(50):
            ids = np.unique(rng.integers(0, 80, int(rng.integers(0, 30))))
            assert sched.run_lengths(ids).tolist() == [r.count for r in sched.plan(ids.tolist())]


def test_charge_reads_equals_charge_read_one_by_one():
    """One ``charge_reads`` of many run sizes leaves the totals, the bound
    counters and two nested ``track()`` scopes bit-equal to a ``charge_read``
    a run; ``fold`` adds left to right as ``+=`` does."""
    rng = np.random.default_rng(2)
    sides = []
    for batched in (True, False):
        obs = Observability()
        acc = IOAccountant(DISKS["nvme"])
        acc.bind_metrics(obs.registry)
        acc.charge_read(12345)
        with acc.track() as outer:
            acc.charge_read(4096 * 3)
            with acc.track() as inner:
                for _ in range(5):
                    sizes = rng.integers(1, 40, 200) * 3840
                    if batched:
                        acc.charge_reads(sizes)
                    else:
                        for n in sizes.tolist():
                            acc.charge_read(n)
        sides.append((acc.snapshot(), obs.registry.snapshot(), outer, inner))
        rng = np.random.default_rng(2)
    assert sides[0] == sides[1]
    xs = rng.random(1000) * 1e-3
    total = 0.1
    for x in xs.tolist():
        total += x
    assert fold(0.1, xs) == total and fold(0.1, xs[:0]) == 0.1


ENGINE = dict(group_size=4, n_select=6, rank=8, reuse_capacity=4, max_seq=128, kv_bits=8,
              warm_budget_bytes=1 << 20)
STAT_FIELDS = ("io_seconds", "compute_seconds", "pipelined_seconds", "io_bytes",
               "io_requests", "warm_bytes", "h2d_bytes", "active_rows")


@pytest.fixture(scope="module")
def parts(tiny_cfg, tiny_params, tiny_adapter):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tiny_params), "cpu")
    calib = np.random.default_rng(21).standard_normal(
        (256, tiny_cfg.n_kv_heads, tiny_cfg.head_dim)).astype(np.float32)
    prompt = np.random.default_rng(22).integers(0, tiny_cfg.vocab_size, (2, 57))
    return (tiny_adapter, tiny_params,
            TransformerAdapter(ModelConfig(**dataclasses.asdict(tiny_cfg))), params, calib, prompt)


def run_engine(engine, prompt):
    with engine as e:
        tokens = e.generate(prompt, 10)
        return (np.asarray(tokens), [{f: getattr(s, f) for f in STAT_FIELDS} for s in e.step_log],
                e.accountant.snapshot(), dataclasses.asdict(e.warm.stats))


@pytest.mark.parametrize("device_resident", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_a_warm_tier_engine_equals_the_reference(parts, async_io, device_resident):
    """An engine whose fetches go through the warm tier gives the reference
    engine's tokens, modeled steps, I/O accounting and tier counters."""
    cfg = dict(ENGINE, async_io=async_io, device_resident=device_resident)
    want = run_engine(JEngine(parts[0], parts[1], JConfig(**cfg), batch=2, calib_k=parts[4]),
                      parts[5])
    got = run_engine(KVSwapEngine(parts[2], parts[3], EngineConfig(**cfg), batch=2,
                                  calib_k=parts[4], device="cpu"), parts[5])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert want[3]["hits"] > 0 and want[2]["warm_bytes"] > 0
