"""The device-resident fetch's upload slabs (``repro_torch.core.upload``).

A fetch copies each group it serves once into a host slab, with the indices
that place it; the main thread delivers the slab in one copy, writes the
reuse mirror and overwrites the staged groups' context rows.  Held here: the
staged indices against the per-group loop they replace, the mirror equal to
the host reuse slots bit for bit after every step, a fetch that misses on
every selected group filling the slab to its bound, a failed fetch leaving
the ring whole, and the slab counters.  The ``cuda`` cases run on the card
(pinned slabs, the copy's events, two workers over many steps) and skip
without one.  The file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upload.py
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig, KVSwapEngine
from repro_torch.core.manager import KVCacheManager
from repro_torch.core.offload import KVDiskStore
from repro_torch.core.reuse_buffer import DeviceReuseMirror, ReuseBuffer
from repro_torch.core.rolling_buffer import RollingBuffer
from repro_torch.core.upload import SlabRing, staged_tokens
from repro_torch.faults.errors import FetchFailed
from repro_torch.models.transformer import ModelConfig, TransformerAdapter, init_params
from repro_torch.obs import Observability
from repro_torch.serving import ServeSession

CFG = ModelConfig(name="tiny", arch_type="dense", n_layers=3, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=97)
# reuse capacity under the selection: groups are staged every step
ENGINE = dict(group_size=4, n_select=5, rank=8, reuse_capacity=2, max_seq=256)


@pytest.fixture(scope="module")
def parts():
    params = init_params(CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    calib = np.random.default_rng(5).standard_normal((256, 2, 16)).astype(np.float32)
    return TransformerAdapter(CFG), params, calib


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned slabs and copy events)")
    return torch.device("cuda")


def bits(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def assert_mirrors_hold_the_host_slots(engine):
    """Every resident slot of every layer's device mirror equals the host
    reuse slot bit for bit (K and V)."""
    for reuse in engine.reuse:
        held = reuse.slot_table != -1
        assert held.any()
        for half, dev in ((0, reuse.device.k), (1, reuse.device.v)):
            np.testing.assert_array_equal(bits(dev.cpu().numpy()[held]),
                                          bits(reuse.slots[:, :, :, half][held]))


def serve(parts, *, device="cpu", obs=None, check=None, n_new=9, lengths=(37, 45, 53),
          **engine):
    """Requests through a two-slot session; ``check(engine)`` after every
    decode step.  Returns the tokens by request and the session's engine."""
    model, params, calib = parts
    rng = np.random.default_rng(1)
    with ServeSession(model, params, EngineConfig(**{**ENGINE, **engine}), slots=2,
                      calib_k=calib, device=device, obs=obs) as s:
        if check is not None:
            step = s.engine.decode_step

            def checked(tok):
                out = step(tok)
                check(s.engine)
                return out

            s.engine.decode_step = checked
        for n in lengths:
            s.submit(rng.integers(0, CFG.vocab_size, n), n_new)
        done = s.drain()
    return {rid: req.output.tolist() for rid, req in done.items()}, s.engine


def loop_staged(group_ids, slots, staged, g):
    """The per-group loop the slab's staged indices replace: for each staged
    group, every position holding it, as (row, token) pairs and payloads."""
    rows_b, rows_t, pay = [], [], []
    for (bi, gid), kv in staged.items():
        for mi in np.nonzero((group_ids[bi] == gid) & (slots[bi] == -2))[0]:
            rows_b.extend([bi] * g)
            rows_t.extend(range(int(mi) * g, (int(mi) + 1) * g))
            pay.append(kv)
    return np.array(rows_b, np.int64), np.array(rows_t, np.int64), pay


def test_staged_indices_equal_the_loop_they_replace():
    """Random tables with masked rows (top-k repeating id 0), groups
    selected twice, resident and staged groups: the slab's staged tokens
    are the loop's (row, token) pairs, and delivered over a context they
    write what the loop's ``index_put_`` wrote."""
    b, m, g, c, shape = 3, 8, 4, 3, (4, 2, 2, 3)
    for seed in range(20):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, 6, (b, m))
        mask = rng.random((b, m)) < 0.8
        ids[1], mask[1] = 0, rng.random(m) < 0.5       # a short row: id 0 repeated
        slots = np.full((b, m), -1, np.int64)
        staged = {}
        for bi in range(b):
            where = {int(gid): int(rng.integers(-2, c)) for gid in np.unique(ids[bi])}
            where = {gid: (-2 if s < 0 else s) for gid, s in where.items()}
            for mi in np.flatnonzero(mask[bi]):
                slots[bi, mi] = where[int(ids[bi, mi])]
                if slots[bi, mi] == -2:
                    staged[(bi, int(ids[bi, mi]))] = rng.standard_normal(shape).astype(np.float32)
        want_b, want_t, pay = loop_staged(ids, slots, staged, g)
        rows, pos, tok_rows, toks = staged_tokens(slots, g)
        assert sorted(zip(tok_rows.tolist(), toks.tolist())) == sorted(
            zip(want_b.tolist(), want_t.tolist()))

        ring = SlabRing(1, batch=b, n_select=m, group_shape=shape, dtype=np.float32,
                        device="cpu")
        kvs = [staged[(r, int(ids[r, p]))] for r, p in zip(rows, pos)]
        none = np.zeros(0, np.int64)
        up = ring.fill(lambda out: np.stack(kvs, out=out), 0, len(kvs), none, none,
                       slots, np.zeros(b, np.int64), tok_rows, toks)
        mirror = DeviceReuseMirror(np.zeros((b, c) + shape, np.float32), None, "cpu")
        dev = ring.deliver(up, mirror, b, m)
        got_k, got_v, want_k, want_v = (torch.zeros(b, m * g + g, 2, 3) for _ in range(4))
        dev.put_staged(got_k, got_v)
        if pay:
            kv = torch.from_numpy(np.concatenate(pay))
            want_k.index_put_((torch.from_numpy(want_b), torch.from_numpy(want_t)), kv[:, 0])
            want_v.index_put_((torch.from_numpy(want_b), torch.from_numpy(want_t)), kv[:, 1])
        assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
        np.testing.assert_array_equal(dev.slots.numpy(), slots)
        assert ring.n_free == 1 and mirror.scatter_calls == 0


@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_the_mirror_holds_the_host_slots_after_every_step(parts, async_io):
    """C < M, so every step both writes the mirror and stages groups; after
    each step the mirror equals the host reuse slots bit for bit, and the
    tokens equal the host-gather route's."""
    steps = []
    got, eng = serve(parts, async_io=async_io,
                     check=lambda e: (assert_mirrors_hold_the_host_slots(e), steps.append(1)))
    assert len(steps) > 10 and eng.slabs.n_free == len(eng.slabs.slabs)
    assert sum(r.device.uploaded_groups for r in eng.reuse) > 0
    want, _ = serve(parts, async_io=async_io, device_resident=False)
    assert got == want


def test_a_fetch_that_misses_every_group_fills_the_slab():
    """Every selected group of every row misses the reuse buffer: the slab
    holds exactly B × M groups, the mirror's (all it can take) then the
    staged ones, each the bytes the store holds for that group."""
    b, m, c, g, h, d = 2, 6, 4, 4, 2, 8
    store = KVDiskStore(n_layers=1, batch=b, max_groups=16, group_size=g, n_kv_heads=h,
                        head_dim=d)
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal((b, 16 * g, h, d)).astype(np.float32) for _ in range(2))
    store.write_prefill(0, k, v)
    ring = SlabRing(1, batch=b, n_select=m, group_shape=(g, 2, h, d), dtype=np.float32,
                    device="cpu")
    mgr = KVCacheManager(store=store, reuse=ReuseBuffer(batch=b, capacity=c, group_size=g,
                                                        n_kv_heads=h, head_dim=d),
                         rolling=RollingBuffer(batch=b, group_size=g, n_kv_heads=h, head_dim=d),
                         layer=0, slabs=ring)
    ids = np.stack([rng.permutation(16)[:m] for _ in range(b)])
    table = mgr.fetch(ids, np.ones((b, m), bool))
    up = table.upload
    assert up.n_mirror == b * c and up.n_staged == b * (m - c) and up.n_mirror + up.n_staged == b * m
    payload = up.slab.u8[:b * m * ring.group_nbytes].view(np.float32).reshape(b * m, g, 2, h, d)
    # the disk tier serves a row's misses in ascending id order: the first C
    # take the free slots, the rest are staged (in the table's row-major order)
    rows, pos, _, _ = staged_tokens(table.slots, g)
    order = [(r, gid) for r in range(b) for gid in sorted(ids[r])[:c]]
    order += [(r, ids[r, p]) for r, p in zip(rows, pos)]
    want = np.stack([store.peek_run(0, r, int(gid), 1).block[0] for r, gid in order])
    np.testing.assert_array_equal(bits(payload), bits(want))
    store.close()


@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_a_failed_fetch_leaves_the_ring_whole(parts, async_io, monkeypatch):
    """Layer 1's fetch raises ``FetchFailed`` in the fourth step, while (async)
    layer 2's table already holds a slab: the session fails that request,
    replays the other, the ring has every slab back, and later steps
    decode."""
    model, params, calib = parts
    rng = np.random.default_rng(2)
    with ServeSession(model, params, EngineConfig(**ENGINE, async_io=async_io), slots=2,
                      calib_k=calib, device="cpu") as s:
        eng, ring = s.engine, s.engine.slabs
        disk, nxt = eng.managers[1].disk, eng.managers[2]
        real, real_next = disk.vet, nxt.fetch
        next_filled, failed_once = threading.Event(), threading.Event()

        def fetch_next(ids, mask):
            table = real_next(ids, mask)
            if len(eng.step_log) == 3:
                next_filled.set()
            return table

        def vet(row, gids):
            if len(eng.step_log) == 3 and not failed_once.is_set():
                failed_once.set()
                # async: fail once layer 2's table holds its slab
                assert not async_io or next_filled.wait(30)
                raise FetchFailed("injected", layer=disk.layer, row=row, start=int(gids[0]),
                                  count=1)
            return real(row, gids)

        monkeypatch.setattr(disk, "vet", vet)
        monkeypatch.setattr(nxt, "fetch", fetch_next)
        rids = [s.submit(rng.integers(0, CFG.vocab_size, n), 8) for n in (41, 49)]
        steps_before = None
        while s.has_work:
            s.step()
            if failed_once.is_set() and steps_before is None:
                steps_before = len(eng.step_log)
                assert ring.n_free == len(ring.slabs)
        done, failed = s.drain(), s.failed
    assert steps_before is not None and len(eng.step_log) > steps_before
    assert len(failed) == 1 and [len(done[r].output) for r in rids if r not in failed] == [8]
    assert ring.n_free == len(ring.slabs)


def test_the_slab_counters_count_what_was_delivered(parts):
    """``kvswap_upload_slab_bytes_total`` is the mirror's uploaded bytes plus
    the staged groups' (a group at each staged position); no fetch on the
    CPU waits for a copy."""
    obs = Observability()
    staged_groups = []
    model, params, calib = parts

    def hook(layer, x, pos, table):
        staged_groups.append(int((table.slots == -2).sum()))

    rng = np.random.default_rng(4)
    with ServeSession(model, params, EngineConfig(**ENGINE), slots=2, calib_k=calib,
                      device="cpu", obs=obs) as s:
        s.engine.layer_hook = hook
        for n in (37, 45):
            s.submit(rng.integers(0, CFG.vocab_size, n), 7)
        s.drain()
        eng = s.engine
    gnb = eng.slabs.group_nbytes
    mirror = sum(r.device.uploaded_bytes for r in eng.reuse)
    assert sum(staged_groups) > 0 and mirror > 0
    reg = obs.registry
    assert reg.get("kvswap_upload_slab_bytes_total").value == mirror + sum(staged_groups) * gnb
    assert reg.get("kvswap_upload_slab_waits_total").value == 0


def test_the_ring_hands_each_slab_to_one_holder_at_a_time():
    """Sixteen threads (more than the cores) take and return three slabs
    under a switch interval of a microsecond: a slab is never held twice
    (each holder's mark survives its hold) and the ring ends whole."""
    ring = SlabRing(3, batch=1, n_select=1, group_shape=(1, 2, 1, 1), dtype=np.float32,
                    device="cpu")
    holders = threading.BoundedSemaphore(len(ring.slabs))
    clashes = []

    def work(mark):
        for _ in range(200):
            with holders:
                slab = ring.acquire()
                slab.u8[:8].view(np.int64)[0] = mark
                time.sleep(0)
                if slab.u8[:8].view(np.int64)[0] != mark:
                    clashes.append(mark)
                ring.release(slab)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert clashes == [] and ring.n_free == len(ring.slabs)


@pytest.mark.cuda
def test_the_slabs_are_pinned_on_the_card(parts, cuda_device):
    model, params, calib = parts
    from repro_torch.bridge import params_from_numpy

    dev_params = params_from_numpy(params, cuda_device)
    for aio, n in ((True, 3), (False, 1)):
        with KVSwapEngine(model, dev_params, EngineConfig(**ENGINE, async_io=aio), batch=2,
                          calib_k=calib, device=cuda_device) as eng:
            assert len(eng.slabs.slabs) == n
            assert all(s.words.is_pinned() for s in eng.slabs.slabs)
            assert all(s.event is not None for s in eng.slabs.slabs)


@pytest.mark.cuda
def test_two_workers_keep_the_mirror_whole_over_many_steps(parts, cuda_device):
    """A tiny engine with two prefetch workers over 48 decode steps on the
    card: after every step the mirror equals the host slots; the tokens
    equal the card's host-gather route's; the slabs' bytes and waits are
    counted."""
    model, params, calib = parts
    from repro_torch.bridge import params_from_numpy

    dev_parts = (model, params_from_numpy(params, cuda_device), calib)
    obs = Observability()
    got, eng = serve(dev_parts, device=cuda_device, obs=obs, io_threads=2, n_new=48,
                     lengths=(61, 70), check=assert_mirrors_hold_the_host_slots)
    want, _ = serve(dev_parts, device=cuda_device, io_threads=2, n_new=48, lengths=(61, 70),
                    device_resident=False)
    assert got == want
    reg = obs.registry
    assert reg.get("kvswap_upload_slab_bytes_total").value > 0
    assert reg.get("kvswap_upload_slab_waits_total").value >= 0
    assert eng.slabs.n_free == len(eng.slabs.slabs)

