"""The batched fetch against the per-group walk it stands in for.

Over a plain ``KVDiskStore`` with the disk tier alone, ``KVCacheManager.fetch``
plans each row's misses in numpy, charges the same runs in one call, places
them in the reuse buffer in one call and reads them with one gather; over a
``FaultyDisk`` (here with a plan that injects nothing) it walks the tier
chain group by group.  Two managers over the same data, fed the same drifting
selections, must end each step equal: the mapping table (staged keys and
bytes too), the slab's payload and index block, the reuse buffer's state and
host slots, the device mirror, the accountant's snapshot and the
``kvswap_io_*`` and ``kvswap_read_plan_*`` counters.  Held besides: each
batched piece against the loop it replaces, where the walk is kept, and an
engine over the batched path against one over the walk.  The file imports
neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fetch_batched.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.core.manager import KVCacheManager
from repro_torch.core.offload import NVME, IOAccountant, KVDiskStore
from repro_torch.core.reuse_buffer import ReuseBuffer
from repro_torch.core.rolling_buffer import RollingBuffer
from repro_torch.core.upload import SlabRing
from repro_torch.faults import FaultPlan, FaultSpec, FaultyDisk
from repro_torch.faults.retry import RetryPolicy
from repro_torch.io.scheduler import ReadScheduler
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.obs import Observability
from repro_torch.obs.metrics import fold
from repro_torch.serving import ServeSession
from repro_torch.tiers import WarmTier

B, MAX_GROUPS, LAYER, STEPS = 3, 56, 1, 32
BATCHED = "kvswap_fetch_batched_groups_total"
# the cells' shapes in small: G, planes, H_kv, d, reuse capacity C, selection
# M, int8 store, coalescing gap
SHAPES = {
    "granite": dict(g=4, planes=2, h=2, d=8, c=6, m=10, bits=0, gap=0),      # C < M: staged
    "granite-gap2": dict(g=4, planes=2, h=2, d=8, c=6, m=10, bits=0, gap=2),
    "mla": dict(g=3, planes=1, h=1, d=20, c=4, m=12, bits=0, gap=0),         # one plane
    "olmoe": dict(g=4, planes=2, h=2, d=8, c=20, m=6, bits=0, gap=0),        # C > M
    "int8": dict(g=4, planes=2, h=2, d=8, c=5, m=9, bits=8, gap=0),
}


def raw(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def build(sh, *, faulted, slabs, data):
    """One manager of layer ``LAYER`` over its own store holding ``data``."""
    obs = Observability()
    acc = IOAccountant(NVME)
    acc.bind_metrics(obs.registry)
    store = KVDiskStore(n_layers=2, batch=B, max_groups=MAX_GROUPS, group_size=sh["g"],
                        n_kv_heads=sh["h"], head_dim=sh["d"], accountant=acc,
                        quant_bits=sh["bits"], planes=sh["planes"])
    if faulted:
        store = FaultyDisk(store, FaultPlan(FaultSpec()))
    for bi, (k, v) in enumerate(data):
        store.write_prefill_row(LAYER, bi, k, v)
    reuse = ReuseBuffer(batch=B, capacity=sh["c"], group_size=sh["g"], n_kv_heads=sh["h"],
                        head_dim=sh["d"], planes=sh["planes"])
    ring = None
    if slabs:
        ring = SlabRing(1, batch=B, n_select=sh["m"],
                        group_shape=(sh["g"], sh["planes"], sh["h"], sh["d"]),
                        dtype=np.float32, device="cpu", obs=obs)
        reuse.attach_device_mirror("cpu")
    mgr = KVCacheManager(store=store, reuse=reuse, layer=LAYER, obs=obs, slabs=ring,
                         rolling=RollingBuffer(batch=B, group_size=sh["g"], n_kv_heads=sh["h"],
                                               head_dim=sh["d"], planes=sh["planes"]),
                         scheduler=ReadScheduler(sh["gap"]), retry=RetryPolicy())
    return mgr, obs


def selections(rng, m, n_groups):
    """Drifting top-M selections: about a quarter of a row's ids change a
    step (ids may repeat); now and then a short row (masked tail, id 0) and
    an idle row (all masked)."""
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
            if k.startswith(("kvswap_io_", "kvswap_read_plan_"))}


def assert_tables_equal(ta, tb):
    for f in ("group_ids", "slots", "group_mask", "rolling_fill"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    assert list(ta.staged) == list(tb.staged)
    for key, kv in ta.staged.items():
        np.testing.assert_array_equal(raw(kv), raw(tb.staged[key]))


def assert_reuse_equal(ra, rb):
    np.testing.assert_array_equal(ra.slot_table, rb.slot_table)
    assert ra._index == rb._index and ra._free == rb._free
    assert [list(f) for f in ra._fifo] == [list(f) for f in rb._fifo]
    assert ra.stats == rb.stats
    np.testing.assert_array_equal(raw(ra.slots), raw(rb.slots))


@pytest.mark.parametrize("slabs", [True, False], ids=["slab", "host"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batched_fetch_equals_the_per_group_walk(shape, slabs):
    sh = SHAPES[shape]
    rng = np.random.default_rng(7)
    n_groups = [40, 44, 36]
    data = [tuple(rng.standard_normal((n * sh["g"] + 2, sh["h"], sh["d"])).astype(np.float32)
                  for _ in range(2)) for n in n_groups]
    (a, oa), (b, ob) = (build(sh, faulted=f, slabs=slabs, data=data) for f in (False, True))
    served = staged = 0
    for t, (ids, mask) in enumerate(selections(rng, sh["m"], n_groups)):
        misses0 = a.reuse.stats.misses
        ta, tb = a.fetch(ids, mask), b.fetch(ids, mask)
        served += a.reuse.stats.misses - misses0
        staged += len(ta.staged)
        assert_tables_equal(ta, tb)
        if slabs:
            ua, ub = ta.upload, tb.upload
            assert (ua.n_mirror, ua.n_staged, ua.index_at, ua.nbytes) == (
                ub.n_mirror, ub.n_staged, ub.index_at, ub.nbytes)
            pay = (ua.n_mirror + ua.n_staged) * a.slabs.group_nbytes
            np.testing.assert_array_equal(ua.slab.u8[:pay], ub.slab.u8[:pay])
            np.testing.assert_array_equal(ua.slab.u8[ua.index_at:ua.nbytes],
                                          ub.slab.u8[ub.index_at:ub.nbytes])
            (_, ha), (_, hb) = a.sync_device(ta), b.sync_device(tb)
            assert ha == hb
            np.testing.assert_array_equal(raw(a.reuse.device.k), raw(b.reuse.device.k))
        else:
            for x, y in zip(a.gather(ta), b.gather(tb)):
                np.testing.assert_array_equal(raw(x), raw(y))
        assert_reuse_equal(a.reuse, b.reuse)
        assert a.store.accountant.snapshot() == b.store.accountant.snapshot()
        assert counters(oa) == counters(ob)
        if t % 4 == 3:   # each row's next group lands on both stores
            for bi in range(B):
                k, v = rng.standard_normal((2, sh["g"], sh["h"], sh["d"])).astype(np.float32)
                a.store.append_group_row(LAYER, bi, k, v)
                b.store.append_group_row(LAYER, bi, k, v)
            n_groups[:] = [n + 1 for n in n_groups]
    snap_a, snap_b = oa.registry.snapshot(), ob.registry.snapshot()
    assert served > 0 and snap_a[BATCHED] == served and snap_b[BATCHED] == 0
    assert (staged > 0) == (sh["c"] < sh["m"])
    assert a.disk.retries == b.disk.retries == 0
    if not sh["gap"]:
        assert snap_a[BATCHED] == snap_a["kvswap_read_plan_groups_read_total"]


def test_place_equals_the_insert_loop():
    """``ReuseBuffer.place`` then one indexed write leaves what ``insert`` on
    each group in turn leaves: free slots in pop order, unprotected
    residents evicted in FIFO order (the victim sink called for each, in
    that order, with the bytes the slot held), the rest without a slot."""
    g, h, d, c = 2, 1, 3, 5
    for seed in range(40):
        rng = np.random.default_rng(seed)
        loop, batch = (ReuseBuffer(batch=2, capacity=c, group_size=g, n_kv_heads=h, head_dim=d)
                       for _ in range(2))
        sunk = {id(loop): [], id(batch): []}
        for buf in (loop, batch):
            buf.victim_sink = lambda bi, gid, kv, _to=sunk[id(buf)]: _to.append(
                (bi, gid, kv.copy()))
        for _ in range(12):
            bi = int(rng.integers(2))
            want = [int(x) for x in rng.choice(30, int(rng.integers(1, 9)), replace=False)]
            hits, misses = loop.lookup(bi, want)
            assert (hits, misses) == batch.lookup(bi, want)
            gids = np.sort(np.array(misses, np.int64))
            kv = rng.standard_normal((gids.size, g, 2, h, d)).astype(np.float32)
            got = [loop.insert(bi, int(x), kv[i], protected=set(want)) for i, x in
                   enumerate(gids.tolist())]
            at = batch.place(bi, gids, set(want))
            batch.slots[bi, at[at >= 0]] = kv[at >= 0]
            assert at.tolist() == [-1 if s is None else s for s in got]
            assert_reuse_equal(loop, batch)
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
        acc = IOAccountant(NVME)
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


@pytest.mark.parametrize("watched", ["faulty", "warm", "spied-read", "replaced-serve"])
def test_the_walk_is_kept_where_reads_are_watched(watched):
    """A fault store (which forwards every attribute, a batched one too), a
    warm tier, or a read replaced on the store or the tier keeps the
    per-group walk: every read goes through ``read_run``, and the batched
    counter stays at 0."""
    sh = SHAPES["granite"]
    rng = np.random.default_rng(3)
    data = [tuple(rng.standard_normal((40 * sh["g"], sh["h"], sh["d"])).astype(np.float32)
                  for _ in range(2)) for _ in range(B)]
    mgr, obs = build(sh, faulted=watched == "faulty", slabs=True, data=data)
    if watched == "warm":
        warm = WarmTier(budget_bytes=1 << 20, accountant=mgr.store.accountant, obs=obs)
        mgr.store.warm = warm
        mgr = KVCacheManager(store=mgr.store, reuse=mgr.reuse, rolling=mgr.rolling, layer=LAYER,
                             warm=warm, obs=obs, slabs=mgr.slabs)
    reads = []
    if watched == "spied-read":
        real = mgr.store.read_run
        mgr.store.read_run = lambda *a: reads.append(a) or real(*a)
    if watched == "replaced-serve":
        real_serve = mgr.disk.serve_run
        mgr.disk.serve_run = lambda *a: reads.append(a) or real_serve(*a)
    for ids, mask in selections(rng, sh["m"], [40] * B):
        table = mgr.fetch(ids, mask)
        mgr.sync_device(table)
    snap = obs.registry.snapshot()
    assert snap.get(BATCHED, 0) == 0 and snap["kvswap_read_plan_groups_read_total"] > 0
    assert watched not in ("spied-read", "replaced-serve") or reads


@pytest.fixture(scope="module")
def parts():
    cfg = ModelConfig(name="tiny", arch_type="dense", n_layers=3, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=97)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    calib = np.random.default_rng(5).standard_normal((256, 2, 16)).astype(np.float32)
    return TransformerAdapter(cfg), params, calib


@pytest.mark.parametrize("device_resident", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_an_engine_on_the_batched_path_equals_one_on_the_walk(parts, async_io, device_resident):
    """Requests through a session whose store is plain (every fetch batched:
    the batched counter equals the groups read) and through one whose store
    injects nothing (the walk): the same tokens, modeled steps and I/O."""
    model, params, calib = parts
    cfg = EngineConfig(group_size=4, n_select=5, rank=8, reuse_capacity=2, max_seq=256,
                       async_io=async_io, device_resident=device_resident)
    runs = []
    for faults in (None, FaultPlan(FaultSpec())):
        obs = Observability()
        rng = np.random.default_rng(1)
        with ServeSession(model, params, cfg, slots=2, calib_k=calib, device="cpu", obs=obs,
                          faults=faults) as s:
            for n in (37, 45, 53):
                s.submit(rng.integers(0, 97, n), 9)
            done = s.drain()
            runs.append(({r: q.output.tolist() for r, q in done.items()},
                         [(st.io_seconds, st.io_bytes, st.h2d_bytes) for st in s.engine.step_log],
                         s.engine.accountant.snapshot(), obs.registry.snapshot()))
    (tok_a, steps_a, acc_a, snap_a), (tok_b, steps_b, acc_b, snap_b) = runs
    assert tok_a == tok_b and steps_a == steps_b
    assert acc_a["read_bytes"] == acc_b["read_bytes"] and acc_a["read_requests"] == acc_b[
        "read_requests"]
    read = snap_a["kvswap_read_plan_groups_read_total"]
    assert read > 0 and snap_a[BATCHED] == read and snap_b.get(BATCHED, 0) == 0
    assert read == snap_b["kvswap_read_plan_groups_read_total"]
